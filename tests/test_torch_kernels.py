"""The CUDA kernels' plain versions against the JAX package's Pallas kernels.

The JAX kernels run in interpret mode on the CPU, as ``tests/test_pallas.py``
runs them; the port's wrappers take their plain PyTorch versions for CPU
tensors. The CUDA kernels themselves are compared with these plain
versions on the card by ``chip_smoke.py``.

Tolerance rtol 1e-5 in f32 and bf16 (started at 1e-5 / 1e-4). Reached
on the CPU: f32 3.3e-7 (A) and 2.1e-7 (B) — the same terms summed in
another order; bf16 4.1e-7 (A) — the same operand rounding points (bf16
h0, h1, W1, W2 with f32 sums), where a sum that differs in its last f32
bit can still round a hidden value to the other bf16 neighbour; bf16 B
exactly 0 — the same bf16-rounded differences summed in f32. Above 32
members B's plain version takes the sorted identity in f32, which rounds
no difference to bf16: 2.2e-6 reached at M=33 in bf16 (each difference
within 2^-9 of the Pallas kernel's, which bounds the sum; the roundings
average out over the pairs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close

from probunet_tpu_torch.ops.kernels import afcrps, fcomb_crps

RTOL = {"float32": 1e-5, "bfloat16": 1e-5}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H, W, K, C = 5, 7, 3, 32  # ragged pixel count: 35 is no multiple of any tile


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 5, 16, 33])
def test_afcrps_plain_matches_pallas(m, dtype):
    from probunet_tpu.ops.pallas.afcrps import ensemble_crps_terms

    rng = np.random.default_rng(m)
    p = H * W * K
    ens = rng.standard_normal((2, m, p)).astype(np.float32)
    tgt = rng.standard_normal((2, p)).astype(np.float32)
    w1, w2 = ensemble_crps_terms(jnp.asarray(ens, JNP[dtype]), jnp.asarray(tgt, JNP[dtype]))
    before = afcrps.ensemble_crps_terms.launches
    g1, g2 = afcrps.ensemble_crps_terms(torch.from_numpy(ens).to(TORCH[dtype]),
                                        torch.from_numpy(tgt).to(TORCH[dtype]))
    assert afcrps.ensemble_crps_terms.launches == before  # CPU: plain version, no launch
    assert g1.dtype == g2.dtype == torch.float32
    assert_close(g1, np.asarray(w1), RTOL[dtype], what="t1")
    assert_close(g2, np.asarray(w2), RTOL[dtype], what="t2")


def test_afcrps_plain_sorted_form_above_32_members():
    """M > 32 takes the sorted identity; it equals the pairwise sum."""
    from probunet_tpu_torch.ops.losses import _pairwise_abs_sum

    ens = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 64),
                                                                    dtype=np.float32))
    _, t2 = afcrps.ensemble_crps_terms_plain(ens, ens[:, 0])
    assert_close(t2, _pairwise_abs_sum(ens), 1e-5)


def test_crps_terms_score_the_member_major_view_in_place(monkeypatch):
    """``Fcomb.ensemble``'s output is a member-major view, ``transpose(0, 1)``
    of an (M, B, H, W, K) tensor. ``_crps_terms`` hands it to the kernel
    wrapper as it is (same storage and strides, no copy), with the same
    (t1, t2) and gradients as a contiguous copy; a view whose pixel stride
    is not 1 is copied first."""
    from probunet_tpu_torch.ops import losses

    rng = np.random.default_rng(7)
    m, b, p = 5, 2, H * W * K
    raw = rng.standard_normal((m, b, H, W, K)).astype(np.float32)
    raw[1, :, 0, 0] = raw[0, :, 0, 0]   # ties
    tgt = torch.from_numpy(rng.standard_normal((b, 1, p)).astype(np.float32))
    g1, g2 = (torch.from_numpy(rng.standard_normal(b).astype(np.float32)) for _ in range(2))
    seen = []
    wrapper = afcrps.ensemble_crps_terms
    monkeypatch.setattr(afcrps, "ensemble_crps_terms", lambda e, t: seen.append(e) or wrapper(e, t))
    out, leaves = {}, {}
    for layout in ("view", "copy"):
        leaves[layout] = torch.from_numpy(raw.copy()).requires_grad_()
        ens = leaves[layout].transpose(0, 1)
        if layout == "copy":
            ens = ens.contiguous()
        t1, t2 = losses._crps_terms(ens.reshape(b, m, p), tgt)
        torch.autograd.backward((t1, t2), (g1, g2))
        out[layout] = (t1.detach(), t2.detach(), leaves[layout].grad)
    assert seen[0].data_ptr() == leaves["view"].data_ptr()
    assert seen[0].stride() == (p, b * p, 1)
    for got, want, what in zip(out["view"], out["copy"], ("t1", "t2", "dx")):
        assert_close(got, want, 1e-6, 0, what)
    assert torch.equal(out["view"][2], out["copy"][2])  # sign counts: exact
    strided = torch.from_numpy(raw.reshape(b, p, m)).transpose(1, 2)  # pixel stride m
    assert strided.stride(2) != 1
    losses._crps_terms(strided, tgt)
    assert seen[-1].is_contiguous()


def _fcomb_inputs(m, seed):
    rng = np.random.default_rng(seed)
    p = H * W
    return [rng.standard_normal(s).astype(np.float32) for s in
            [(2, C, p), (2, C, m), (C, C), (C,), (C, K), (K,), (2, K, p)]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 5, 16])
def test_fcomb_crps_plain_matches_pallas(m, dtype):
    from probunet_tpu.ops.pallas.fcomb_crps import fcomb_crps_terms

    args = _fcomb_inputs(m, seed=10 + m)
    w1, w2 = fcomb_crps_terms(*map(jnp.asarray, args), compute_dtype=dtype)
    before = fcomb_crps.fcomb_crps_terms.launches
    g1, g2 = fcomb_crps.fcomb_crps_terms(*map(torch.from_numpy, args), compute_dtype=dtype)
    assert fcomb_crps.fcomb_crps_terms.launches == before
    assert_close(g1, np.asarray(w1), RTOL[dtype], what="t1")
    assert_close(g2, np.asarray(w2), RTOL[dtype], what="t2")


@pytest.mark.parametrize("loss_type,dtype", [("afcrps", "float32"), ("crps", "float32"),
                                             ("afcrps", "bfloat16")])
def test_fused_fcomb_crps_loss_matches_jax(loss_type, dtype):
    """The whole fused loss, layer-0 projections included, with the Fcomb
    parameters carried from the JAX (1, 1, cin, cout) layout."""
    from probunet_tpu.ops.pallas.fcomb_crps import fused_fcomb_crps_loss as jax_loss

    rng = np.random.default_rng(3)
    d, m = 4, 5
    feats = rng.standard_normal((2, H, W, C)).astype(np.float32)
    zs = rng.standard_normal((m, 2, d)).astype(np.float32)
    tgt = rng.standard_normal((2, H, W, K)).astype(np.float32)
    shapes = {"layer0": (C + d, C), "layer1": (C, C), "layer2": (C, K)}
    jparams = {}
    for name, (cin, cout) in shapes.items():
        jparams[f"{name}_weight"] = (rng.standard_normal((1, 1, cin, cout))
                                     / np.sqrt(cin)).astype(np.float32)
        jparams[f"{name}_bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    want = jax_loss(jnp.asarray(feats), jnp.asarray(zs),
                    {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(tgt),
                    loss_type, compute_dtype=dtype)
    tparams = {k: torch.from_numpy(v[0, 0] if v.ndim == 4 else v) for k, v in jparams.items()}
    got = fcomb_crps.fused_fcomb_crps_loss(torch.from_numpy(feats), torch.from_numpy(zs),
                                           tparams, torch.from_numpy(tgt), loss_type,
                                           compute_dtype=dtype)
    assert_close(got, float(want), RTOL[dtype], what=loss_type)


def test_wrappers_refuse_non_cpu_tensors_without_the_kernel():
    """A tensor that is not on the CPU never reaches a plain version: a
    device the kernels do not serve raises instead of falling back."""
    ens = torch.empty(2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        afcrps.ensemble_crps_terms(ens, torch.empty(2, 8, device="meta"))
    args = [torch.empty(s, device="meta") for s in
            [(2, C, 8), (2, C, 3), (C, C), (C,), (C, K), (K,), (2, K, 8)]]
    with pytest.raises(ValueError, match="CUDA"):
        fcomb_crps.fcomb_crps_terms(*args)


# ---------------------------------------------------------------------------
# The backwards (kernels A′, B′) and dropout (kernel D). Plain versions
# against jax.vjp of the Pallas kernels in interpret mode, with the same
# numpy cotangents. B′ and D are sign counts and hash masks: equal exactly
# (B′ to 1 ulp where XLA may contract g1*s0 + g2*count into one FMA). A′:
# f32 rtol 1e-5 / atol 1e-5 — the same products summed over pixels in
# another order; bf16 rtol 1e-4 / atol 1e-4 — a sum that differs in its
# last f32 bit can round an operand (da1, dx) to the other bf16 neighbour.
# ---------------------------------------------------------------------------

BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 5, 33])
def test_afcrps_backward_plain_matches_pallas_vjp(m, dtype):
    import jax

    from probunet_tpu.ops.pallas.afcrps import ensemble_crps_terms

    rng = np.random.default_rng(20 + m)
    p = H * W * K
    ens = rng.standard_normal((2, m, p)).astype(np.float32)
    ens[:, 1, :4] = ens[:, 0, :4]   # ties: sign 0 in the pair counts
    tgt = rng.standard_normal((2, p)).astype(np.float32)
    tgt[:, 4:6] = ens[:, 0, 4:6]    # and against the target
    g1, g2 = (rng.standard_normal(2).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(ensemble_crps_terms, jnp.asarray(ens, JNP[dtype]),
                     jnp.asarray(tgt, JNP[dtype]))
    want_dx, want_dy = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    tens = torch.from_numpy(ens).to(TORCH[dtype]).requires_grad_()
    ttgt = torch.from_numpy(tgt).to(TORCH[dtype]).requires_grad_()
    t1, t2 = afcrps.ensemble_crps_terms(tens, ttgt)
    torch.autograd.backward((t1, t2), (torch.from_numpy(g1), torch.from_numpy(g2)))
    assert tens.grad.dtype == TORCH[dtype] and ttgt.grad.dtype == TORCH[dtype]
    assert_close(tens.grad.float(), np.asarray(want_dx, np.float32), 1e-6, 0, "dx")
    assert_close(ttgt.grad.float(), np.asarray(want_dy, np.float32), 1e-6, 0, "dy")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 5])
def test_fcomb_crps_backward_plain_matches_pallas_vjp(m, dtype):
    """All seven cotangents: dfeat, dz, dW1, db1, dW2, db2, dy."""
    import jax

    from probunet_tpu.ops.pallas.fcomb_crps import fcomb_crps_terms as jax_terms

    args = _fcomb_inputs(m, seed=30 + m)
    args[2] /= np.sqrt(C)
    args[4] /= np.sqrt(C)
    rng = np.random.default_rng(40 + m)
    g1, g2 = (rng.standard_normal(2).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda *a: jax_terms(*a, compute_dtype=dtype), *map(jnp.asarray, args))
    want = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    before = fcomb_crps.fcomb_crps_terms_bwd.launches
    t1, t2 = fcomb_crps.fcomb_crps_terms(*targs, compute_dtype=dtype)
    torch.autograd.backward((t1, t2), (torch.from_numpy(g1), torch.from_numpy(g2)))
    assert fcomb_crps.fcomb_crps_terms_bwd.launches == before  # CPU: plain, no launch
    rtol, atol = BWD_TOL[dtype]
    for name, t, w in zip(("dfeat", "dz", "dW1", "db1", "dW2", "db2", "dy"), targs, want):
        assert float(np.abs(np.asarray(w)).max()) > 0, name
        assert_close(t.grad, np.asarray(w), rtol, atol, name)


def test_fcomb_crps_backward_skips_dy_when_not_asked():
    args = [torch.from_numpy(a) for a in _fcomb_inputs(3, seed=50)]
    for a in args[:6]:
        a.requires_grad_()
    t1, t2 = fcomb_crps.fcomb_crps_terms(*args, compute_dtype="float32")
    (t1.sum() + t2.sum()).backward()
    assert args[6].grad is None and args[0].grad is not None
    grads = fcomb_crps.fcomb_crps_terms_bwd_plain(
        *[a.detach() for a in args], torch.ones(2), torch.ones(2), "float32", need_dy=False)
    assert grads[-1] is None


@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "tensor_core"), ("float32", "fp32")])
def test_fcomb_crps_backward_kernel_is_chosen_by_dtype(monkeypatch, dtype, kernel):
    """Kernel A′ has two CUDA kernels: bf16 operands on the tensor cores,
    f32 operands on the FP32 pipes. The wrapper picks one from the
    compute dtype alone, before it loads the library, and hands it to the
    launch: no fallback from one to the other."""
    def no_library():
        raise AssertionError("the choice needs no library")

    seen = []
    monkeypatch.setattr(fcomb_crps._build, "library", no_library)
    monkeypatch.setattr(fcomb_crps, "_launch_bwd",
                        lambda args, which, need_dy: seen.append(which) or "launched")
    args = [torch.empty(s, device="meta") for s in
            [(2, C, 8), (2, C, 3), (C, C), (C,), (C, K), (K,), (2, K, 8), (2,), (2,)]]
    assert fcomb_crps.fcomb_crps_terms_bwd(*args, compute_dtype=dtype) == "launched"
    assert seen == [kernel] and fcomb_crps.BWD_KERNELS[dtype] == kernel


@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "tensor_core"), ("float32", "fp32")])
def test_fcomb_crps_forward_kernel_is_chosen_by_dtype(monkeypatch, dtype, kernel):
    """Kernel A has two CUDA kernels as A′ has: bf16 operands on the tensor
    cores (with A′'s decode), f32 operands on the FP32 pipes. The wrapper
    picks one from the compute dtype alone, before it loads the library,
    and hands it to the launch: no fallback from one to the other."""
    def no_library():
        raise AssertionError("the choice needs no library")

    seen = []
    monkeypatch.setattr(fcomb_crps._build, "library", no_library)
    monkeypatch.setattr(fcomb_crps, "_launch",
                        lambda args, which: seen.append(which) or "launched")
    args = [torch.empty(s, device="meta") for s in
            [(2, C, 8), (2, C, 3), (C, C), (C,), (C, K), (K,), (2, K, 8)]]
    assert fcomb_crps.fcomb_crps_terms_fwd(*args, compute_dtype=dtype) == "launched"
    assert seen == [kernel] and fcomb_crps.FWD_KERNELS[dtype] == kernel


def test_fcomb_crps_supported_shapes_match_the_source():
    """``fcomb_crps.supported``, the rule the ELBO's route follows, holds
    the limits kernels A and A′ are built with (csrc/fcomb_crps.cu)."""
    import re

    from probunet_tpu_torch.ops.kernels import _build

    text = (_build.CSRC_DIR / "fcomb_crps.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kC|kMaxM|kMaxK) = (\d+);", text))
    assert consts == {"kC": str(fcomb_crps.CHANNELS), "kMaxM": str(fcomb_crps.MAX_MEMBERS),
                      "kMaxK": str(fcomb_crps.MAX_CLASSES)}
    assert f"batch <= {fcomb_crps.MAX_BATCH}" in text
    assert fcomb_crps.supported(32, 15, 3, 128) and fcomb_crps.supported(32, 32, 4, 65535)
    for c, m, k, b in [(16, 15, 3, 128), (64, 15, 3, 128), (32, 33, 3, 128), (32, 1, 3, 128),
                       (32, 15, 5, 128), (32, 15, 3, 65536)]:
        assert not fcomb_crps.supported(c, m, k, b), (c, m, k, b)


def test_c_entry_signatures_match_the_sources():
    """Every C entry of csrc/*.cu is declared to ctypes with its arguments'
    count and types: a pointer as c_void_p, an int as c_int, a float as
    c_float, a long long as c_longlong. ctypes checks neither, and a
    mismatch shows only on the card."""
    import ctypes
    import re

    from probunet_tpu_torch.ops.kernels import _build

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
             "longlong": ctypes.c_longlong}
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        text = src.read_text()
        if 'extern "C" {' not in text:
            continue
        block = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"^(?:int|const char\*) (\w+)\(([^)]*)\)", block, re.M):
            types = []
            for param in filter(None, (p.strip() for p in params.split(","))):
                words = param.replace("const ", "").replace("*", " * ").split()
                kind = "void*" if "*" in words else "".join(words[:-1])
                types.append(kinds[kind])
            found[name] = tuple(types)
    assert set(_build._SIGNATURES) <= set(found), set(_build._SIGNATURES) - set(found)
    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes == found[name], name


# rows = numel / 128 against _block_rows: 16 rows in one block; 6144 in
# three blocks of 2048; 2064 in two of 1032; 2056 in 257 of 8
DROPOUT_SHAPES = [(2, 4, 4, 64), (3, 32, 64, 128), (2, 12, 86, 128), (2, 1028, 128)]


@pytest.mark.parametrize("shape", DROPOUT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_plain_matches_pallas_bit_for_bit(shape, dtype):
    import jax

    from probunet_tpu.ops.pallas import dropout as jdrop

    from probunet_tpu_torch.ops.kernels import dropout as tdrop

    assert tdrop.supported(shape) and jdrop.supported(shape)
    assert tdrop._block_rows(int(np.prod(shape)) // 128) == jdrop._block_rows(
        int(np.prod(shape)) // 128)
    rng = np.random.default_rng(len(shape) + shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    seed = np.array([-123456789, 987654321], np.int32)
    p = 0.1
    want_y, vjp = jax.vjp(lambda a: jdrop.dropout(a, jnp.asarray(seed), p),
                          jnp.asarray(x, JNP[dtype]))
    (want_dx,) = vjp(jnp.asarray(g, JNP[dtype]))
    tx = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
    y = tdrop.dropout(tx, torch.from_numpy(seed), p)
    y.backward(torch.from_numpy(g).to(TORCH[dtype]))
    assert y.dtype == tx.grad.dtype == TORCH[dtype]
    assert np.array_equal(y.detach().float().numpy(), np.asarray(want_y, np.float32))
    assert np.array_equal(tx.grad.float().numpy(), np.asarray(want_dx, np.float32))
    keep = (y.detach() != 0).float().mean().item()
    n = int(np.prod(shape))
    assert abs(keep - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5


def test_dropout_mask_is_a_function_of_the_seed():
    from probunet_tpu_torch.ops.kernels import dropout as tdrop

    shape = (4, 8, 8, 32)
    s1, s2 = torch.tensor([1, 2], dtype=torch.int32), torch.tensor([1, 3], dtype=torch.int32)
    k1, k1b, k2 = (tdrop.dropout_keep(shape, s, 0.25) for s in (s1, s1, s2))
    assert torch.equal(k1, k1b) and not torch.equal(k1, k2)
    with pytest.raises(ValueError, match="CUDA"):
        tdrop.dropout(torch.empty(shape, device="meta"), s1.to("meta"), 0.1)
