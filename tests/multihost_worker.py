"""Worker process for the multi-process (simulated multi-host) test.

Each instance is one fake 'host': it joins the jax.distributed process
group over localhost, renders the sharded image on the global mesh, and
asserts its addressable shards equal a locally-computed single-device
render (SURVEY §4: 'multi-host without a pod').
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    port = sys.argv[1]
    num = int(sys.argv[2])
    pid = int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")
    from ray_tracer_tpu.parallel import multihost
    from ray_tracer_tpu.utils.cache import use_compile_cache

    use_compile_cache()

    multihost.initialize(
        coordinator_address=f"localhost:{port}", num_processes=num, process_id=pid
    )
    assert jax.process_count() == num, jax.process_count()

    import dataclasses

    import numpy as np

    from ray_tracer_tpu.models.scenes import gradcheck_scene
    from ray_tracer_tpu.parallel.shard import render_sharded
    from ray_tracer_tpu.render.renderer import prepare, render

    scene, cfg = gradcheck_scene(16, 16)
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, ray_tile=64)
    )
    prep = prepare(cfg, scene=scene)
    img = render_sharded(prep, mesh=multihost.global_mesh(("rays",)))
    single = np.asarray(render(prep))  # replicated local computation
    for shard in img.addressable_shards:
        assert np.array_equal(np.asarray(shard.data), single[shard.index]), (
            f"process {pid}: shard {shard.index} mismatch"
        )
    assert not multihost.is_host0() or pid == 0
    lo, hi = multihost.host_tile_bounds(256)
    assert 0 <= lo <= hi <= 256

    # ---- ring-sharded paths over TRUE process boundaries (round 5) ----
    # The tris axis spans processes, so every ppermute hop of the ring
    # orbit crosses the jax.distributed transport — the most complex
    # shard_map code in the repo (parallel/shard.py) exercised where a
    # single-process virtual mesh cannot catch transport bugs.
    import jax.numpy as jnp

    from ray_tracer_tpu.opt.fit import (
        make_ring_train_step, make_train_step, split_scene,
    )
    from ray_tracer_tpu.parallel.shard import render_sharded_geometry
    from ray_tracer_tpu.render.pathtrace import pathtrace_rays

    ring_mesh = multihost.global_mesh(("rays", "tris"),
                                      shape=(1, jax.device_count()))
    cfg_r = dataclasses.replace(
        cfg, render=dataclasses.replace(
            cfg.render, faithful=False, det_dtype="float32",
            traversal="packed", fused_shadow=False,
        ),
    )
    prep_r = prepare(cfg_r, scene=scene)

    # (a) ring render: grid hops + merges orbit through every process
    img_ring = render_sharded_geometry(prep_r, mesh=ring_mesh)
    from ray_tracer_tpu.render.renderer import render as _render

    single_r = np.asarray(_render(prep_r))
    for shard in img_ring.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(shard.data), single_r[shard.index],
            atol=5e-3, rtol=1e-3,
            err_msg=f"process {pid}: ring shard {shard.index} mismatch",
        )

    # (b) ring GI: path segments and occlusion queries orbit the ring
    cfg_gi = dataclasses.replace(
        cfg_r, render=dataclasses.replace(
            cfg_r.render, gi_samples=1, gi_depth=1,
        ),
    )
    prep_gi = prepare(cfg_gi, scene=scene)
    img_gi = render_sharded_geometry(prep_gi, mesh=ring_mesh)
    from ray_tracer_tpu.ops.camera import camera_rays

    rays_gi = camera_rays(cfg_gi.camera, dtype=jnp.float32)
    want_gi = np.asarray(pathtrace_rays(
        rays_gi, prep_gi.scene, prep_gi.packed.arrays, prep_gi.packed.meta,
        cfg_gi,
    )).reshape(cfg_gi.camera.height, cfg_gi.camera.width, 3)
    for shard in img_gi.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(shard.data), want_gi[shard.index],
            atol=5e-3, rtol=1e-3,
            err_msg=f"process {pid}: ring GI shard {shard.index} mismatch",
        )

    # (c) ring TRAIN step: backward through the cross-process orbit;
    # loss must match the locally-computed replicated step
    target = jnp.full((16, 16, 3), 40.0, jnp.float32)
    trainable = ("verts", "base_color", "light_pos")
    params0 = split_scene(prep_r.scene)
    rstep, rinit = make_train_step(
        prep_r.packed.meta, prep_r.cfg, optimizer="sgd", lr=1e-3,
        trainable=trainable,
    )
    rparams, _, rloss = rstep(params0, rinit(params0), prep_r.scene,
                              prep_r.packed.arrays, target)
    sstep, sinit, ring_scene = make_ring_train_step(
        prep_r, ring_mesh, optimizer="sgd", lr=1e-3, trainable=trainable,
    )
    sparams, _, sloss = sstep(params0, sinit(params0), ring_scene, target)
    np.testing.assert_allclose(float(sloss), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(sparams.verts), np.asarray(rparams.verts), atol=1e-5
    )

    # host-0 framebuffer assembly + PPM artifact (the runnable multi-
    # host demo: every host contributes shards, host 0 writes the file)
    out_dir = sys.argv[4] if len(sys.argv) > 4 else None
    if out_dir:
        from ray_tracer_tpu.io.ppm import read_ppm, tonemap_u8

        path = os.path.join(out_dir, "multihost.ppm")
        wrote = multihost.write_ppm_host0(path, img)
        assert wrote == (pid == 0)
        if wrote:
            assert np.array_equal(read_ppm(path), tonemap_u8(single)), (
                "host-0 assembled PPM differs from the replicated render"
            )
    print(f"proc {pid} OK", flush=True)


if __name__ == "__main__":
    main()
