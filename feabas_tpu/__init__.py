"""feabas_tpu: accelerator-native elastic stitching & 3D alignment for EM
connectomics.

A ground-up JAX/XLA rebuild of the capabilities of FEABAS
(YuelongWu/feabas). See ARCHITECTURE.md for the design.
"""

__version__ = '0.2.0'

# package-level constants, like the reference's `import feabas;
# feabas.MESH_GEAR_FIXED` idiom (reference: feabas/__init__.py)
from feabas_tpu.constant import *  # noqa: F401,F403
