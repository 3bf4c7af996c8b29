"""Built-in datasets: download-and-cache Subject factories.

The port's copy of ``torchio_tpu/datasets``, built from the port's
Subject and Image. Grouped by source; ``__all__`` is derived from the
tables, so an export cannot go stale. Everything downloads on first use
into the user cache directory (``utils.get_cache_dir()``).
"""

# atlases (MNI) + reference subject
from .mni import Colin27, ICBM2009CNonlinearSymmetric, Pediatric, Sheep, SubjectMNI
from .fpg import FPG

# sample subjects from tool ecosystems
from .itk_snap import AorticValve, BrainTumor, SubjectITKSNAP, T1T2
from .slicer import Slicer

# cohorts / ML benchmarks
from .ixi import ixi, ixi_tiny
from .medmnist import (
    adrenal_mnist_3d,
    fracture_mnist_3d,
    nodule_mnist_3d,
    organ_mnist_3d,
    synapse_mnist_3d,
    vessel_mnist_3d,
)

# synthetic (offline, no download)
from .zone_plate import ZonePlate

_ATLASES = (Colin27, ICBM2009CNonlinearSymmetric, Pediatric, Sheep, SubjectMNI, FPG)
_SAMPLES = (AorticValve, BrainTumor, SubjectITKSNAP, T1T2, Slicer, ZonePlate)
_COHORTS = (
    ixi, ixi_tiny,
    adrenal_mnist_3d, fracture_mnist_3d, nodule_mnist_3d,
    organ_mnist_3d, synapse_mnist_3d, vessel_mnist_3d,
)

__all__ = sorted(o.__name__ for group in (_ATLASES, _SAMPLES, _COHORTS) for o in group)
