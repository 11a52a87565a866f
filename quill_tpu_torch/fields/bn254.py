"""BN254 curve and field constants.

These mirror the parameters of `ark-bn254` 0.5, which the reference stack
(`quill-zkvm/pcs/src/kzg.rs:114`, `hyperplonk/tests/test_basic_proof.rs:1-2`)
instantiates everything with.  All values are standard, public BN254 (alt_bn128)
parameters.
"""

# Base field modulus (Fq)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Scalar field modulus (Fr) -- the field the proof system works over
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Curve: y^2 = x^3 + 3 over Fq
B_COEFF = 3

# G1 generator
G1_X = 1
G1_Y = 2

# G2 is defined over Fq2 = Fq[u]/(u^2 + 1); curve y^2 = x^3 + b' with
# b' = 3 / (9 + u).  Generator coordinates (c0, c1) pairs:
G2_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# BN parameter x such that p(x), r(x) follow the BN polynomial family
BN_X = 4965661367192848881
# Optimal ate Miller loop count: 6x + 2
ATE_LOOP_COUNT = 6 * BN_X + 2

# Non-residues:
# Fq2 = Fq[u]/(u^2 - FQ2_NONRESIDUE), FQ2_NONRESIDUE = -1
FQ2_NONRESIDUE = P - 1
# Fq6 = Fq2[v]/(v^3 - XI), XI = 9 + u
XI = (9, 1)

# 2-adicity of Fr: r - 1 = 2^28 * odd
FR_TWO_ADICITY = 28
# Smallest multiplicative generator of Fr (from ark-bn254: GENERATOR = 5)
FR_GENERATOR = 5
# 2^28-th primitive root of unity in Fr: g^((r-1)/2^28)
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)

# Serialized byte length of one Fq or Fr element (ark-serialize: (MODULUS_BITS+7)/8)
FIELD_BYTES = 32
# Number of challenge bytes drawn for one field element:
# (MODULUS_BIT_SIZE + 128 + 7) / 8 with MODULUS_BIT_SIZE = 254
# (`quill-zkvm/transcript/src/transcript.rs:70-74`)
CHALLENGE_BYTES = (254 + 128 + 7) // 8  # = 48
