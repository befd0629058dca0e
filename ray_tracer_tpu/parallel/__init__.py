"""Multi-device / multi-host execution.

The reference is single-GPU with no distributed backend (SURVEY.md §2:
the only transport is cudaMemcpy, Parallel/raytracer.cu:583-693).  This
package is the scaling layer it lacks:

  * `mesh`        — device-mesh construction ("rays" × "tris" axes);
  * `shard`       — shard_map renderers: rays/tiles data-parallel over
                    the mesh, geometry replicated; triangle-sharded
                    all-pairs intersection for giant scenes;
  * `collectives` — the explicit collectives API (tile scatter, image
                    gather, gradient all-reduce) layered on XLA
                    psum/all_gather across devices.
"""

from ray_tracer_tpu.parallel.mesh import make_mesh
from ray_tracer_tpu.parallel.shard import render_sharded

__all__ = ["make_mesh", "render_sharded"]
