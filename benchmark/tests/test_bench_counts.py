"""The frozen yardstick: FLOPs counted over the reference on meta tensors
equal the program's own count over its plain route, and the kernels'
least times at the flagship's main shapes."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, TINY_VALUES


def _sizes(cfg):
    from benchmark import harness

    data = json.loads((ROOT / "benchmark" / "configs" / f"{cfg}.json").read_text())
    return harness.sizes(harness.Cell("x", {"params": {}}, data, {}))


def test_flagship_counts():
    from benchmark import counts

    train, chains = counts.train_step(_sizes("probunet_multivar_128"), 15)
    assert train * 128 == 12_507_149_565_952 and len(chains) == 57
    serve, chains = counts.sample(_sizes("probunet_multivar_128"), 16)
    assert serve * 128 == 3_759_144_992_768 and len(chains) == 57


@pytest.mark.parametrize("mode,members", [("train", 3), ("ensemble", 16)])
def test_counts_equal_the_programs_plain_route(mode, members):
    from benchmark import counts, harness
    from probunet_tpu_torch import bench
    from probunet_tpu_torch.cli import make_model
    from probunet_tpu_torch.data.climex import compute_stats

    cell = harness.Cell("x", {"params": {}}, {"preset": "probunet_multivar_128",
                                              "values": TINY_VALUES}, {})
    cfg = harness.port_config(cell)
    cfg.train.ensemble_size = members
    model = make_model(cfg, "cpu")
    hr = torch.rand((4, 32, 32, 3)) * 5 + 1
    stats = compute_stats(hr, 4)
    want = bench.flops_per_unit(mode, model, cfg, stats, None, hr, 1)
    got = (counts.train_step if mode == "train" else counts.sample)(harness.sizes(cell),
                                                                    members)[0]
    assert got == want


def test_kernel_bounds_at_the_main_shapes():
    from benchmark import counts

    ms = 1e3
    assert round(counts.gn_bound_s((128, 32, 128, 128), True, "bfloat16", False) * ms, 4) == 0.0801
    assert round(counts.gn_bound_s((128, 32, 128, 128), True, "bfloat16", True) * ms, 4) == 0.1202
    assert round(counts.fcomb_crps_bound_s(128, 16384, 15, 32, 3, "bfloat16", False) * ms,
                 4) == 0.0876
    assert round(counts.fcomb_crps_bound_s(128, 16384, 15, 32, 3, "bfloat16", True) * ms,
                 4) == 0.2137


def test_families():
    from benchmark import counts

    assert counts.family("void gn_bwd_cluster_kernel<...>") == "C' fused_gn bwd"
    assert counts.family("sm90_xmma_fprop_implicit_gemm") == "cuDNN/cuBLAS"
    assert counts.family("void at::native::vectorized_elementwise_kernel") == "other"
