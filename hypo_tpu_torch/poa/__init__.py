"""Window consensus of the PyTorch port: the host POA (graph, align,
engine, host_runner, colpoa_ref, copied from hypo_tpu/poa/ with its
exports, hypo_tpu/poa/__init__.py) and the device path (dp, cuda_*,
device_full, batch, full_runner).  Device constants copied from
hypo_tpu.poa.jax_poa (:29-37) and hypo_tpu.poa.device_full (:52-55),
which import jax."""
from .graph import Graph  # noqa: F401
from .align import PoaAligner, NW, LOV, ROV, SW, OV  # noqa: F401

NEG16 = -16384       # DP cell sentinel (jax_poa.NEG16 == pallas_poa.NEG)
NEG = -(2 ** 30)     # consensus score sentinel
BIG = 2 ** 30        # rank of an invalid node
NCODES = 6           # A C G T J O

GLOBAL_ALPHABET = "ACGTJO"
GLOBAL_CODE = {c: i for i, c in enumerate(GLOBAL_ALPHABET)}
