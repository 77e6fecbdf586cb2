"""echopype_tpu: JAX-native ocean sonar (echosounder) data processing.

A ground-up JAX/XLA/Pallas rebuild with the capabilities of echopype
(reference: OSOceanAcoustics/echopype): convert raw instrument files into the
SONAR-netCDF4 convention, calibrate to Sv/TS, and post-process (noise removal,
masking, echo-integration onto common grids, metrics) — with the compute core
running as fused jit kernels over [channel, ping_time, range_sample] blocks
and scaling over device meshes via shard_map.
"""

from .convert.api import open_raw  # noqa: F401
from .echodata.api import open_converted  # noqa: F401
from .echodata.combine import combine_echodata  # noqa: F401
from .echodata.echodata import EchoData  # noqa: F401
from .utils.log import verbose  # noqa: F401
from .utils.prov import ECHOPYPE_TPU_VERSION as __version__  # noqa: F401

from . import (  # noqa: F401, E402
    calibrate,
    clean,
    colormap,
    commongrid,
    consolidate,
    mask,
    metrics,
    qc,
    utils,
    xrlite,
)

__all__ = [
    "open_raw",
    "open_converted",
    "combine_echodata",
    "EchoData",
    "verbose",
    "calibrate",
    "clean",
    "colormap",
    "commongrid",
    "consolidate",
    "mask",
    "metrics",
    "qc",
    "utils",
    "xrlite",
]
