#!/usr/bin/env python
"""Standalone repro for the XLA:CPU compile-accumulation segfault.

What it reproduces: running the WHOLE test suite in one pytest process
(``python -m pytest tests/``) segfaults on some hosts inside
``jax/_src/compiler.py backend_compile_and_load`` after ~200 compiled
programs accumulate in a single process — observed 4/4 on jaxlib 0.9.0
in the ``tests/test_sharding.py`` ring-program region, with the
persistent compile cache fresh, stale, or disabled.  Every test file
passes in its own process, so the suite runs batched
(``tools/run_tests.py``); this script packages the crash itself so the
environment pin can be re-checked after any jaxlib bump.

Two modes, both run the risky work in a CHILD process and report its
exit status (a segfault must not kill the reporter):

  python tools/repro_xla_segfault.py             # suite mode (default)
  python tools/repro_xla_segfault.py --synthetic # minimal program loop

* suite mode replays the documented crash protocol exactly: one pytest
  process over the whole ``tests/`` tree with the same 8-virtual-device
  CPU env the suite uses.  rc -11 (SIGSEGV) = reproduced.
* synthetic mode compiles N DISTINCT tiny programs (alternating plain
  jits and 8-device shard_map ring programs, each with a unique shape
  so nothing cache-hits) in one child process.  This isolates "compiled
  program count" from test content.  Measured on this host (jaxlib
  0.9.0): 400 synthetic programs SURVIVE — raw count alone does not
  trigger the crash, so suite mode (the real program mix: large fused
  while_loops, scatter/gather-heavy traversals, multi-collective ring
  programs) is the authoritative repro.

Environment pin: the workaround (and this repro) were validated on
jaxlib 0.9.0 / jax 0.9.x.  After ANY jaxlib change, run suite mode:
  * rc 0      -> the upstream bug is gone; tools/run_tests.py can be
                 retired to a plain ``pytest tests/`` run.
  * rc -11    -> still present; keep the batched runner.
  * other rc  -> the failure mode changed; re-diagnose before trusting
                 the batched runner's green.
No upstream issue could be filed from this machine (zero egress); the
crash signature to search/report is "backend_compile_and_load segfault
after ~200 XLA:CPU compilations in one process, jaxlib 0.9.0".
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SYNTH_SRC = r"""
import os, sys
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

n_prog = int(sys.argv[1])
assert len(jax.devices()) >= 8, jax.devices()
devs = np.array(jax.devices()[:8])
mesh = Mesh(devs, ("d",))
for i in range(n_prog):
    # unique shapes defeat both the in-process executable cache and the
    # persistent compile cache: every iteration is a REAL backend compile
    k = 16 + i
    if i % 2 == 0:
        x = jnp.arange(k * 8, dtype=jnp.float32).reshape(8, k)

        def ring(v):
            nxt = jax.lax.ppermute(
                v, "d", [(j, (j + 1) % 8) for j in range(8)]
            )
            return jax.lax.psum(nxt * v, "d")

        f = jax.jit(jax.shard_map(
            ring, mesh=mesh, in_specs=P("d"), out_specs=P()
        ))
        f(x).block_until_ready()
    else:
        x = jnp.ones((k,), jnp.float32)
        jax.jit(lambda v, s=i: jnp.cumsum(v) * s + jnp.sin(v).sum())(
            x
        ).block_until_ready()
    if (i + 1) % 50 == 0:
        print(f"compiled {i + 1}/{n_prog} programs", flush=True)
print("SURVIVED", n_prog, "compilations")
"""


def child_env() -> dict:
    env = dict(os.environ)
    # the suite's exact backend setup (tests/conftest.py): CPU platform,
    # 8 virtual devices; compile cache OFF so every program is a real
    # backend_compile_and_load call (the crash reproduces with the cache
    # on, off, fresh and stale — off is the most deterministic)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


def report(rc: int, what: str) -> int:
    if rc == -11:
        print(f"\nREPRODUCED: {what} died with SIGSEGV (rc -11) — the "
              "XLA:CPU compile-accumulation crash is still present; keep "
              "tools/run_tests.py as the suite runner.")
        return 0  # reproducing the bug is this script's success case
    if rc == 0:
        print(f"\nNOT REPRODUCED: {what} survived. If this is a newer "
              "jaxlib than 0.9.0, the upstream bug may be fixed — try "
              "`python -m pytest tests/ -q` directly.")
        return 1
    print(f"\nUNEXPECTED exit {rc} from {what} — the failure mode has "
          "changed; re-diagnose before trusting either runner.")
    return 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="compile N distinct tiny programs instead of "
                         "running the full suite in one process")
    ap.add_argument("-n", type=int, default=400,
                    help="synthetic mode: number of distinct programs")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()

    import jaxlib

    print(f"jaxlib {jaxlib.__version__} (workaround pinned against 0.9.0)")
    if args.synthetic:
        cmd = [sys.executable, "-c", _SYNTH_SRC, str(args.n)]
        what = f"synthetic loop ({args.n} programs)"
    else:
        cmd = [sys.executable, "-m", "pytest", "tests/", "-q", "-p",
               "no:cacheprovider"]
        what = "one-process full suite"
    print(f"running {what} in a child process ...", flush=True)
    try:
        r = subprocess.run(cmd, cwd=REPO, env=child_env(),
                           timeout=args.timeout)
    except subprocess.TimeoutExpired:
        print("child timed out — treat as NOT reproduced (slow host?)")
        return 2
    return report(r.returncode, what)


if __name__ == "__main__":
    sys.exit(main())
