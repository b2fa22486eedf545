"""What JAX's multi-host mode does where the port refuses: two JAX processes
on the CPU, one device each (``lmnet_tpu/parallel/mesh.py``'s
``make_mesh`` and ``shard_batch``, as ``tests/_mh_worker.py`` drives them).

  spatial  a ('data' 1, 'spatial' 2) mesh across the processes: the global
           batch ``shard_batch`` makes from each process's (2, 32, 32, 3)
  steps    process 0 takes one step (a jitted sum over a global batch) more
           than process 1, which goes on to ``process_allgather`` (the
           collective of ``train/loop.py::_allreduce_eval``)

Run from the repository root on the CPU: ``JAX_PLATFORMS=cpu python
tests/_torch_jax_multihost_probe.py``. It prints each process's lines and
whether the processes were still running after ``--wait`` seconds (then
killed: a hang).
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child() -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.experimental import multihost_utils

    from lmnet_tpu.parallel import dist_utils
    from lmnet_tpu.parallel.mesh import make_mesh, shard_batch

    dist_utils.init_distributed_mode()
    pid = jax.process_index()
    x = np.full((2, 32, 32, 3), float(pid + 1), np.float32)
    y = np.zeros((2, 32, 32), np.int32)
    g, _ = shard_batch(make_mesh(n_data=1, n_spatial=2), x, y, spatial=True)
    top = float(jax.jit(lambda a: a[:, :32].mean())(g))
    bottom = float(jax.jit(lambda a: a[:, 32:].mean())(g))
    print("spatial " + json.dumps({"process": pid, "local": x.shape, "global": g.shape,
                                   "top rows' value": top, "bottom rows' value": bottom}),
          flush=True)
    mesh = make_mesh(n_data=2, n_spatial=1)
    step = jax.jit(lambda a: a.sum())
    for i in range(2 if pid == 0 else 1):
        print(f"steps: process {pid} step {i}: {float(step(shard_batch(mesh, x, y, False)[0]))}",
              flush=True)
    print(f"steps: process {pid} at process_allgather", flush=True)
    print(f"steps: process {pid} gathered "
          f"{multihost_utils.process_allgather(np.array([pid])).tolist()}", flush=True)


def main(wait: float = 60.0) -> None:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", JAX_PLATFORMS="cpu",
                   JAX_COORDINATOR_ADDRESS=f"localhost:{port}")
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen([sys.executable, __file__, "--child"], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                      text=True))
    t0 = time.time()
    while time.time() - t0 < wait and any(p.poll() is None for p in procs):
        time.sleep(0.5)
    running = [p.poll() is None for p in procs]
    for p in procs:
        p.kill()  # JAX's preemption notifier catches SIGTERM
    for rank, p in enumerate(procs):
        for line in p.communicate()[0].splitlines():
            print(f"process {rank}| {line}")
    print(f"still running after {wait:.0f} s (killed): {running}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child()
    else:
        main(float(sys.argv[sys.argv.index("--wait") + 1]) if "--wait" in sys.argv else 60.0)
