from ray_tracer_tpu.ops.camera import camera_rays  # noqa: F401
from ray_tracer_tpu.ops.intersect import (  # noqa: F401
    cramer_tbg,
    intersect_brute,
)
from ray_tracer_tpu.ops.traverse import TraceResult, traverse_grid  # noqa: F401
