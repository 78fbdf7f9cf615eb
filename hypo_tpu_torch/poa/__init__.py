"""Device POA for the PyTorch port.  Constants copied from
hypo_tpu.poa.jax_poa (:29-37) and hypo_tpu.poa.device_full (:52-55),
which import jax."""

NW, LOV, ROV = 0, 1, 2
NEG16 = -16384       # DP cell sentinel (jax_poa.NEG16 == pallas_poa.NEG)
NEG = -(2 ** 30)     # consensus score sentinel
BIG = 2 ** 30        # rank of an invalid node
NCODES = 6           # A C G T J O

GLOBAL_ALPHABET = "ACGTJO"
GLOBAL_CODE = {c: i for i, c in enumerate(GLOBAL_ALPHABET)}
