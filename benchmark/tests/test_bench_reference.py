"""The plain reference against the program's plain route at a tiny size,
and its architecture against the program's at both configurations."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, TINY_VALUES


@pytest.mark.parametrize("cfg", ["probunet_multivar_128", "probunet_latent6_64"])
def test_reference_spec_is_the_programs(cfg):
    from benchmark import harness
    from benchmark.reference.model import ProbUNet
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    data = json.loads((ROOT / "benchmark" / "configs" / f"{cfg}.json").read_text())
    cell = harness.Cell("x", {"params": {}}, data, {})
    ref = ProbUNet(harness.sizes(cell))
    port = ProbabilisticUNet.from_config(harness.port_config(cell), torch.Generator(),
                                         device="cpu")
    assert [(n, tuple(p.shape)) for n, p in port.named_parameters()] == ref.spec
    assert port.unet.dropout_blocks == ref.dropout_blocks


def test_reference_sample_matches_program_plain_route():
    from benchmark import harness, weights
    from benchmark.reference.model import ProbUNet
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    cell = harness.Cell("x", {"params": {}}, {"preset": "probunet_multivar_128",
                                              "values": TINY_VALUES}, {})
    net = ProbUNet(harness.sizes(cell))
    model = ProbabilisticUNet.from_config(harness.port_config(cell), torch.Generator(),
                                          device="cpu")
    w = weights.seeded(net.spec, 2 ** 31 + 3, torch.device("cpu"))
    model.load_state_dict(w)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 32, 32, 3), generator=g)
    eps = torch.randn((3, 2, 4), generator=g)
    with torch.no_grad():
        got = model.sample(x, 3, eps=eps)
        want = net.sample(w, x, eps)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
