"""Kernel E's layout and routes (``probunet_tpu_torch/ops/kernels/int8_conv.py``)
on the CPU: the packed weight slabs, the per-shape plan over the flagship's
convolutions and the kernel's quantization shortcut (the plain version is
held to the JAX package in ``test_torch_quantize.py``).

Tolerances: none. The slabs hold ``QWeight.q`` exactly; the plan is a rule
on integers; the quantization shortcut must give the IEEE quotient's
integer for every input (emulated in numpy's f32, whose multiply, add and
divide round as the card's ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn``).
"""

import numpy as np
import pytest
import torch

from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.ops import quantize as tq
from probunet_tpu_torch.ops.kernels import int8_conv as E

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _unpack(words: np.ndarray, cout: int, cin: int, k: int) -> np.ndarray:
    """(cout, cin, k, k) int8 from the slabs by the kernel's own address of
    input channel ci of output channel co at tap t (``csrc/int8_conv.cu``:
    ``weight_word``, the bulk copy's slab offset and the B descriptor):
    byte ((((co // n_tile * chunks + ci // 32) * k*k + t) * 2 + ci % 32 // 16)
    * n_tile + co % n_tile) * 16 + ci % 16."""
    blocks, chunks, taps, two, n_tile, four = words.shape
    assert (taps, two, four) == (k * k, 2, 4)
    flat = words.view(np.int8).reshape(-1)
    co, ci, t = np.meshgrid(np.arange(cout), np.arange(cin), np.arange(taps), indexing="ij")
    at = (((((co // n_tile) * chunks + ci // 32) * taps + t) * 2 + (ci % 32) // 16)
          * n_tile + co % n_tile) * 16 + ci % 16
    return flat[at].reshape(cout, cin, k, k)


SLAB_CASES = [(k, cin, two) for k in (1, 3) for cin in (3, 6, 32, 96, 512)
              for two in (False, True)]


@pytest.mark.parametrize("k,cin,two", SLAB_CASES,
                         ids=[f"k{k}-cin{c}-{'split' if t else 'single'}"
                              for k, c, t in SLAB_CASES])
def test_packed_slabs_unpack_to_q(k, cin, two):
    """Every weight byte sits where the kernel reads it, and the padding
    (input channels to a multiple of 32, output channels to whole blocks)
    is zero. Single: cout 48 in one block of 64; split: a slice of a cout
    256 convolution in two blocks of 128."""
    cout = 256 if two else 48
    rng = np.random.default_rng(k * 1000 + cin)
    w = torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(np.float32))
    nt = E.block_channels(cout, two)
    assert nt == (128 if two else 64)
    qw = E.quantize_weight(w, nt)
    words = qw.words.numpy()
    assert qw.words.dtype == torch.int32 and words.shape == (
        -(-cout // nt), -(-cin // 32), k * k, 2, nt, 4)
    q = qw.q.numpy()
    assert np.array_equal(_unpack(words, cout, cin, k), q)
    assert np.count_nonzero(words.view(np.int8)) == np.count_nonzero(q)


def _flagship_shapes() -> set:
    """(k, cin, cin2, cout, h, w) of every hooked convolution of the
    flagship's int8 sample call and int8 eval step (bs=1, CPU, random
    weights)."""
    from probunet_tpu_torch.config import preset
    from probunet_tpu_torch.data.climex import compute_stats, preprocess_batch
    from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
    from probunet_tpu_torch.data.transforms import apply_physical_transform
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
    from probunet_tpu_torch.train.loop import make_eval_step

    cfg = preset("probunet_multivar_128")
    model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0),
                                          device="cpu").eval()
    hr = apply_physical_transform(torch.from_numpy(synthetic_climex_fields(
        1, *cfg.data.resolution, cfg.data.variables, seed=0)), cfg.data.variables)
    stats = compute_stats(hr, cfg.data.lowres_scale)
    x = preprocess_batch(hr, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                         cfg.data.interp_mode, cfg.data.epsilon,
                         cfg.data.standardization)["inputs"]
    shapes, calls = set(), []
    forward = tq.int8_forward

    def recording(mod, xin, x2=None):
        shapes.add((mod.weight.shape[-1], xin.shape[1], 0 if x2 is None else x2.shape[1],
                    mod.weight.shape[0], xin.shape[2], xin.shape[3]))
        calls.append(1)
        return forward(mod, xin, x2)

    tq.int8_forward = recording
    try:
        with torch.no_grad(), tq.attached(model, tq.calibrate_sample(model, [x], 1)):
            model.sample(x, 1, eps=torch.zeros(1, 1, cfg.model.latent_dim))
        n_sample = len(calls)
        step = make_eval_step(model, cfg, quant=tq.calibrate_elbo(model, [hr], cfg, stats))
        step(hr, stats, torch.Generator().manual_seed(0))
    finally:
        tq.int8_forward = forward
    assert (n_sample, len(calls) - n_sample) == (87, 101)
    return shapes


def test_plan_routes_every_flagship_convolution():
    """Route "wgmma" for every convolution of the flagship's sample and eval
    paths but the cin = 3 and cin = 6 first convolutions, in bf16 and f32,
    with a ring of 2-4 stages within a block's shared memory; the split
    convolutions' blocks of at most 128 channels; the 1x1 heads on it too."""
    shapes = _flagship_shapes()
    assert len(shapes) == 39
    for dtype in (torch.bfloat16, torch.float32):
        for k, cin, cin2, cout, h, w in sorted(shapes):
            pl = E.plan(k, cin, cin2, cout, h, w, dtype)
            assert pl.route == ("mma_sync" if cin in (3, 6) else "wgmma"), (k, cin, dtype)
            assert pl.n_tile == E.block_channels(cout, cin2 > 0)
            if pl.route == "wgmma":
                assert 2 <= pl.stages <= 4 and pl.smem <= 232448, pl
                assert pl.blocks_per_sm * (pl.smem + 1024) <= 233472, pl
                assert pl.blocks_per_sm == 1 or pl.n_tile * (1 + (cin2 > 0)) <= 64, pl
                assert pl.tile_w == (16 if k == 3 else 8), pl
                if cin2:
                    assert pl.n_tile <= 128
    assert E.plan(1, 256, 0, 32, 1, 1, torch.bfloat16).route == "wgmma"   # the heads


def test_plan_follows_tma_alignment_and_output_channels():
    """The rule at its edges: rows of 16 bytes (cin 8 in bf16, 4 in f32)
    take "wgmma", other widths and cout % 8 != 0 the first design; images 8
    pixels wide take 16 x 8 tiles; f32 at 256 channels still fits 2 stages."""
    bf, f32 = torch.bfloat16, torch.float32
    assert E.plan(3, 8, 0, 32, 16, 16, bf).route == "wgmma"
    assert E.plan(3, 4, 0, 32, 16, 16, f32).route == "wgmma"
    assert E.plan(3, 6, 0, 32, 16, 16, f32).route == "mma_sync"
    assert E.plan(3, 12, 0, 32, 16, 16, bf).route == "mma_sync"
    assert E.plan(1, 32, 12, 32, 16, 16, bf).route == "mma_sync"
    assert E.plan(3, 32, 0, 36, 16, 16, bf).route == "mma_sync"
    assert E.plan(3, 32, 0, 32, 8, 8, bf).tile_w == 8
    pl = E.plan(3, 256, 0, 256, 16, 16, f32)
    assert (pl.route, pl.stages, pl.blocks_per_sm) == ("wgmma", 2, 1) and pl.smem <= 232448
    assert E.block_channels(24) == 32 and E.block_channels(264) == 256
    assert E.block_channels(264, True) == 128


def _quantize_shortcut(x: np.ndarray, s: np.float32) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's ``quantize_n`` in numpy f32, element by element: (int8
    values, whether the IEEE quotient was taken). fmin/fmax drop a NaN as
    the card's do. (The kernel takes the quotient for a whole group of 4 or
    8 elements where any one needs it; the quotient is the reference, so
    the values are the same.)"""
    f, magic = np.float32, np.float32(1.5 * 2 ** 23)
    r = f(1) / s
    with np.errstate(invalid="ignore", over="ignore"):
        qa = (x * r).astype(np.float32)
        t = (np.fmin(np.fmax(qa, f(-127)), f(127)) + magic).astype(np.float32)
        q = t.view(np.int32) - np.int32(0x4B400000)
        near = ~(np.abs(qa - (t - magic)) < f(0.5) - f(2.0 ** -14))
        exact = np.rint(np.fmin(np.fmax((x / s).astype(np.float32), f(-127)), f(127)))
    return np.where(near, exact.astype(np.int32), q).astype(np.int8), near


def test_kernel_quantization_shortcut_gives_the_ieee_quotients_integer():
    """x * fl(1/s), clamped to +-127 and rounded by the 1.5 * 2^23
    addition, decides the integer wherever it lies more than 2^-14 from a
    half-integer and within +-127.5; elsewhere the kernel divides. Held on values placed
    within a few ulps of every half-integer of the range (exact ties
    included), on bf16-rounded normal draws and on the clamp's edges, over
    scales spanning 12 decades and two powers of two; the IEEE quotient is
    taken for few of the random draws at the other scales (at a power of
    two a bf16 input's quotient is often an exact half-integer)."""
    rng = np.random.default_rng(0)
    k = np.arange(-130, 131, dtype=np.float32)
    scales = np.concatenate([np.float32(10.0) ** rng.uniform(-8, 4, 46),
                             [2.0 ** -2, 2.0 ** -10]]).astype(np.float32)
    for s in scales:
        near = [((k + np.float32(0.5)) * s).astype(np.float32)]
        up = down = near[0]
        for _ in range(8):   # 1 to 8 ulps either side
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
            near += [up, down]
        draws = (rng.standard_normal(4096).astype(np.float32) * 40 * s).astype(np.float32)
        bf16 = torch.from_numpy(draws).to(torch.bfloat16).float().numpy()
        x = np.concatenate(near + [draws, bf16, np.float32([0, -0.0, 1e30, -1e30]) * s])
        got, slow = _quantize_shortcut(x, s)
        want = tq.quantize_int8(torch.from_numpy(x), torch.tensor(s)).numpy()
        assert np.array_equal(got, want), s
        if np.frexp(s)[0] != 0.5:
            assert slow[-(2 * 4096 + 4):].mean() < 0.01, s
