"""The port's overlap tiling (``probunet_tpu_torch/parallel/spatial.py``)
against ``probunet_tpu/parallel/spatial.py`` on the same numpy fields:
tile origins, tiles and the ramp weight equal; the stitched field equal
too, the port accumulating the weighted tiles in the JAX module's order
(bit for bit here; XLA may contract a product and a sum into one FMA on
other hosts, where the last bit could differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probunet_tpu.parallel import spatial as js

from probunet_tpu_torch.parallel import spatial as ts

# (domain, tile, overlap, align): the full ClimEx domain padded to the
# 16x pooling grid (9 tiles), a ragged small domain, one tile covering all
CASES = [(288, 128, 16, 16), (70, 32, 8, 1), (36, 16, 4, 4), (24, 32, 8, 1)]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_tile_starts_match_jax(case):
    full, tile, overlap, align = case
    assert ts._tile_starts(full, tile, overlap, align) == js._tile_starts(full, tile, overlap,
                                                                          align)


def test_fulldomain_is_nine_tiles():
    assert ts._tile_starts(288, 128, 16, 16) == [0, 112, 160]
    _, positions = ts.extract_tiles(np.zeros((1, 288, 288, 3), np.float32), 128, 16, 16)
    assert len(positions) == 9


def test_unaligned_domain_raises_like_jax():
    for mod in (ts, js):
        with pytest.raises(ValueError, match="pad the domain"):
            mod._tile_starts(70, 32, 8, 16)


@pytest.mark.parametrize("case", CASES[:3], ids=[str(c) for c in CASES[:3]])
def test_extract_and_stitch_match_jax(case):
    full, tile, overlap, align = case
    rng = np.random.default_rng(full)
    field = rng.standard_normal((2, full, full + align * 2, 3)).astype(np.float32)
    got, pos = ts.extract_tiles(torch.from_numpy(field), tile, overlap, align)
    want, jpos = js.extract_tiles(field, tile, overlap, align)
    assert pos == jpos and np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(ts._ramp_weight(tile), js._ramp_weight(tile))
    # an ensemble axis after the tile axis, values that differ per tile
    members = rng.standard_normal((got.shape[0], 4, tile, tile, 3)).astype(np.float32)
    stitched = ts.stitch_tiles(torch.from_numpy(members), pos, field.shape[1:3])
    ref = np.asarray(js.stitch_tiles(jnp.asarray(members), jpos, field.shape[1:3]))
    assert stitched.shape == (2, 4) + field.shape[1:]
    assert np.array_equal(stitched.numpy(), ref)
    # a field cut and stitched back is itself, up to the blend's rounding
    back = ts.stitch_tiles(got, pos, field.shape[1:3]).numpy()
    np.testing.assert_allclose(back, field, rtol=0, atol=1e-5)


def test_tiled_ensemble_matches_jax():
    """Chunks of 4 tiles, the sampler a function of the tiles and of the
    chunk's start (on the JAX side, the start its folded key stands for)."""
    import jax

    field = np.random.default_rng(3).standard_normal((2, 36, 36, 2)).astype(np.float32)

    def fake(tiles, start):
        members = jnp.arange(3.0, dtype=jnp.float32)[None, :, None, None, None]
        return tiles[:, None] * np.float32(1.0 + 0.5 * start) + members

    base = jax.random.key(0)
    starts = {tuple(np.asarray(jax.random.key_data(jax.random.fold_in(base, i)))): i
              for i in range(0, 2 * 9, 4)}
    want = js.tiled_ensemble(
        lambda t, key: fake(t, starts[tuple(np.asarray(jax.random.key_data(key)))]),
        field, base, 16, 4, batch_tiles=4)
    got = ts.tiled_ensemble(
        lambda t, start: torch.from_numpy(np.array(fake(jnp.asarray(t.numpy()), start))),
        torch.from_numpy(field), 16, 4, batch_tiles=4)
    assert got.shape == (2, 3, 36, 36, 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    whole = ts.tiled_ensemble(lambda t, start: t[:, None].repeat(1, 3, 1, 1, 1),
                              torch.from_numpy(field), 16, 4)
    np.testing.assert_allclose(whole.numpy(), np.repeat(field[:, None], 3, 1), rtol=0, atol=1e-5)


def test_tiled_ensemble_aligned_matches_jax_tiles():
    """``align=`` (as ``infer-domain`` tiles the padded domain): the chunks
    see the JAX package's aligned tiles in order, each with its start, and
    the result is the JAX stitch of their ensembles."""
    field = np.random.default_rng(4).standard_normal((2, 40, 40, 2)).astype(np.float32)
    jt, jpos = js.extract_tiles(jnp.asarray(field), 16, 4, align=4)
    assert ts.tile_positions(40, 40, 16, 4, align=4) == [tuple(p) for p in jpos]

    def fake(tiles, start):
        members = np.arange(3.0, dtype=np.float32)[None, :, None, None, None]
        return np.asarray(tiles)[:, None] * np.float32(1.0 + 0.5 * start) + members

    seen = []

    def sample(t, start):
        seen.append((start, t.shape[0]))
        assert np.array_equal(t.numpy(), np.asarray(jt[start:start + 8]))
        return torch.from_numpy(fake(t.numpy(), start))

    got = ts.tiled_ensemble(sample, torch.from_numpy(field), 16, 4, batch_tiles=8, align=4)
    want = js.stitch_tiles(jnp.concatenate([fake(jt[i:i + 8], i) for i in range(0, 18, 8)]),
                           jpos, (40, 40))
    assert seen == [(0, 8), (8, 8), (16, 2)]
    assert np.array_equal(got.numpy(), np.asarray(want))
