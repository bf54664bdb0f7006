"""The port's halo exchange, mesh tiling and tensor-parallel pair
(``probunet_tpu_torch/parallel/{spatial,tensor_parallel}.py``) on two gloo
ranks spawned on the CPU (``tests/torch_mp.py``, one spawn for the file),
against the JAX functions on the suite's 8-device virtual mesh given the
same inputs and converted weights.

Tolerances: rtol / atol 1e-5, the JAX tests' own
(``tests/test_parallel.py:70,235,302``), for the convolutions through two
libraries; the mesh tiling against the port's single-process tiling bit
for bit (the same arithmetic, tiles gathered in order).
"""

import numpy as np
import pytest
import torch

from torch_mp import spawn
from torch_parity import assert_close
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOL = 1e-5
BATCH_TILES = 5       # a chunk of 5 tiles rounds up to 6 over two ranks


@pytest.fixture(scope="module")
def inputs():
    import jax

    from probunet_tpu.parallel import init_channel_sharded_params

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 16, 3)).astype(np.float32)
    tp = jax.device_get(init_channel_sharded_params(jax.random.key(0), 3, 32, 5))
    return {"halo": {"3x3": (x, (rng.standard_normal((3, 3, 3, 5)) * 0.1).astype(np.float32)),
                     "5x5": (x, (rng.standard_normal((5, 5, 3, 4)) * 0.1).astype(np.float32))},
            "field": rng.standard_normal((2, 80, 80, 2)).astype(np.float32),
            "tp": tp, "tp_x": rng.standard_normal((8, 16, 16, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    from probunet_tpu_torch.convert import convert_channel_sharded

    wd = tmp_path_factory.mktemp("parallel_spatial")
    # the port's kernels are OIHW
    torch.save({k: (x, np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
                for k, (x, w) in inputs["halo"].items()}, wd / "halo.in.pt")
    torch.save({"field": inputs["field"], "batch_tiles": BATCH_TILES}, wd / "tiled.in.pt")
    torch.save({"params": convert_channel_sharded(inputs["tp"]), "x": inputs["tp_x"]},
               wd / "tensor_parallel.in.pt")
    jobs = ("halo", "tiled", "tensor_parallel")
    spawn(list(jobs), wd)
    out = {j: [torch.load(wd / f"{j}.rank{r}.pt", weights_only=False) for r in (0, 1)]
           for j in jobs}
    for j in jobs:   # every rank returns the whole, gathered result
        a, b = out[j]
        for k in a:
            va, vb = (a[k]["out"], b[k]["out"]) if j == "tensor_parallel" else (a[k], b[k])
            assert torch.equal(va, vb), (j, k)
    return {j: v[0] for j, v in out.items()}


@pytest.mark.parametrize("kernel", ["3x3", "5x5"])
def test_halo_conv2d_matches_jax(inputs, runs, kernel):
    """Rows split over a ("spatial" = 2) mesh, the halo exchange by one
    all-gather of the edge rows, a VALID convolution: JAX's halo_conv2d over
    a 2 x 4 ("data", "spatial") mesh, and the unsharded SAME convolution."""
    import jax.numpy as jnp
    from jax import lax

    from probunet_tpu.parallel import halo_conv2d, make_mesh

    x, w = inputs["halo"][kernel]
    want = np.asarray(halo_conv2d(jnp.asarray(x), jnp.asarray(w),
                                  make_mesh(n_data=2, n_spatial=4), axis_name="spatial"))
    same = np.asarray(lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
                                               dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = runs["halo"][kernel]
    assert tuple(got.shape) == want.shape
    assert_close(got, want, TOL, TOL, kernel)
    assert_close(got, same, TOL, TOL, kernel)


def test_tiled_ensemble_with_a_mesh_matches_jax(inputs, runs):
    """tiled_ensemble(mesh=) of a linear sampler over two ranks: JAX's over 8
    devices, and twice the field (``test_parallel.py:235``)."""
    import jax

    from probunet_tpu.parallel import make_mesh, tiled_ensemble

    want = np.asarray(tiled_ensemble(lambda tiles, key: 2.0 * tiles[:, None], inputs["field"],
                                     jax.random.key(0), tile=32, overlap=8, mesh=make_mesh()))
    got = runs["tiled"]["linear"]
    assert tuple(got.shape) == want.shape == (2, 1, 80, 80, 2)
    assert_close(got, want, TOL, TOL, "tiled")
    assert_close(got[:, 0], 2.0 * inputs["field"], TOL, TOL, "twice the field")


def test_tiled_ensemble_with_a_mesh_splits_each_chunk(inputs, runs):
    """Chunks of 5 tiles round up to 6 over two ranks, each wrap-padded and
    split; a sampler that reads its chunk's start and the rows it got
    gives, gathered and stitched, the single-process tiling at chunks of 6
    bit for bit."""
    from probunet_tpu_torch.parallel import tiled_ensemble

    def indexed(tiles, start, rows=None):
        assert rows is None
        idx = torch.arange(tiles.shape[0])
        return (tiles + (start + idx).float()[:, None, None, None])[:, None]

    want = tiled_ensemble(indexed, torch.from_numpy(inputs["field"]), 32, 8,
                          batch_tiles=-(-BATCH_TILES // 2) * 2)
    assert torch.equal(runs["tiled"]["indexed"], want)


def test_channel_sharded_block_matches_jax(inputs, runs):
    """The pair with Cmid = 32 split over a ("model" = 2) mesh (each rank
    holding 16 channels of w1 and w2, one all-reduce) and with the batch
    split over ("data" = 2): JAX's unsharded oracle and its sharded apply
    over a 2 x 4 ("data", "model") mesh (``test_parallel.py:302``)."""
    import jax.numpy as jnp

    from probunet_tpu.parallel import (
        channel_sharded_block,
        make_channel_sharded_apply,
        make_dp_tp_mesh,
        shard_params,
    )

    from probunet_tpu_torch.convert import convert_channel_sharded
    from probunet_tpu_torch.parallel import channel_sharded_block as torch_block

    params = {k: jnp.asarray(v) for k, v in inputs["tp"].items()}
    x = jnp.asarray(inputs["tp_x"])
    want = np.asarray(channel_sharded_block(params, x))
    mesh = make_dp_tp_mesh(n_model=4)
    sharded = np.asarray(make_channel_sharded_apply(mesh)(shard_params(params, mesh), x))
    assert_close(sharded, want, TOL, TOL, "JAX sharded vs unsharded")
    for name, shard in (("model2", (16, 3, 3, 3)), ("model1", (32, 3, 3, 3))):
        got = runs["tensor_parallel"][name]
        assert got["w1_shard"] == shard
        assert tuple(got["out"].shape) == want.shape == (8, 16, 16, 5)
        assert_close(got["out"], want, TOL, TOL, name)
    whole = torch_block(convert_channel_sharded(inputs["tp"]), torch.from_numpy(inputs["tp_x"]))
    assert_close(whole, want, TOL, TOL, "port unsharded")


def test_init_channel_sharded_params_shapes():
    from probunet_tpu_torch.parallel import init_channel_sharded_params

    p = init_channel_sharded_params(torch.Generator().manual_seed(0), 3, 32, 5)
    assert tuple(p["w1"].shape) == (32, 3, 3, 3) and tuple(p["w2"].shape) == (5, 32, 3, 3)
    assert abs(float(p["w1"].std()) * np.sqrt(27) - 1) < 0.2
