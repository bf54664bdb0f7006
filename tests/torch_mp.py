"""Spawn the port's ranks as CPU processes for the parallel-path tests.

:func:`spawn` starts ``world`` processes of ``tests/torch_mp_worker.py``
with ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) under
``PROBUNET_PLATFORM=cpu``, so each rank joins one gloo process group. Each
runs the named jobs in order, reading its inputs from and writing its
outputs to ``workdir``. A rank that fails, or a run that outlasts
``timeout``, fails the test; no process outlives the call.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_mp_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(jobs: list[str], workdir, world: int = 2, timeout: float = 600) -> list[str]:
    """Run ``jobs`` (names of ``torch_mp_worker.JOBS``) on ``world`` gloo
    ranks; returns each rank's output. Asserts every rank exited 0."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.pathsep.join([REPO, TESTS, env.get("PYTHONPATH", "")]),
               PROBUNET_PLATFORM="cpu", OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, WORKER, str(workdir), ",".join(jobs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:   # a hung rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
        assert f"MP_OK rank={r}" in out, out[-6000:]
    return outs


def tiny_cfg(batch: int, m: int, **data):
    """The port's config of ``torch_parity``'s tiny model (16x16, 4x
    pooling) at batch ``batch`` with ``m`` members, ``data`` fields set."""
    from torch_parity import TINY

    from probunet_tpu_torch.config import Config

    cfg = Config()
    cfg.data.resolution, cfg.data.lowres_scale = TINY["img_resolution"], 4
    for k, v in data.items():
        setattr(cfg.data, k, v)
    cfg.model.latent_dim, cfg.model.num_filters = TINY["latent_dim"], TINY["num_filters"]
    cfg.model.model_channels, cfg.model.channel_mult = (TINY["model_channels"],
                                                        TINY["channel_mult"])
    cfg.model.num_blocks = TINY["num_blocks"]
    cfg.train.batch_size, cfg.train.ensemble_size, cfg.train.eval_ensemble_size = batch, m, m
    return cfg
