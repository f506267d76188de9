"""Parity of the port's describe (kernel K3+K4's plain version) with the JAX package.

The port always takes the 32-bin describe of the TPU kernel, so it is held
to ``orb_descriptors_pallas(interpret=True, pass2="sublanes_loop")``, never
to the continuous-angle XLA path the JAX package takes on the CPU. Rule
(the same the card check applies to the kernel): angle bins identical on at
least 99.9% of keypoints, bits equal on at least 99.5%, and equal on every
bit whose two samples differ by more than 1.5 (``test_pallas_orb.py:144``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.ops import features as jfeat
from slideo_tpu.ops import orb as jorb
from slideo_tpu.ops import pallas_orb
from slideo_tpu_torch.ops import cuda_orb, features as tfeat, orb as torb
from test_torch_config import port_cfg

torch.set_num_threads(1)

ORB = dataclasses.replace(
    DEFAULT_CONFIG.orb, n_features=256, max_keypoints=256, n_levels=4, edge_threshold=32,
)
TORB = port_cfg(ORB)


def _scene(seed: int, h: int = 240, w: int = 320) -> np.ndarray:
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 255, np.uint8)
    for _ in range(60):
        y, x = rng.randint(8, h - 20), rng.randint(8, w - 40)
        img[y:y + rng.randint(3, 12), x:x + rng.randint(6, 40)] = rng.randint(0, 200)
    return img


def _ref_bins(atlas: np.ndarray, y0: np.ndarray, x0: np.ndarray) -> np.ndarray:
    """Bins of the JAX pass-1 contract: moments of the patch-aligned TPU
    window against pallas_orb's masks (jnp f32 sums), binned by
    pallas_orb._sector32."""
    mx, my = pallas_orb._moment_masks()
    ha, wa = atlas.shape
    pad = np.zeros((ha + 80, wa + 128), np.float32)
    pad[:ha, :wa] = atlas
    wins = np.zeros((len(y0), 72, 128), np.float32)
    for i, (y, x) in enumerate(zip(y0, x0)):
        wins[i, pallas_orb._ROW0:pallas_orb._ROW0 + 63, :63] = pad[y:y + 63, x:x + 63]
    m10 = jnp.sum(jnp.asarray(wins) * mx, axis=(1, 2))
    m01 = jnp.sum(jnp.asarray(wins) * my, axis=(1, 2))
    return np.asarray(pallas_orb._sector32(m10, m01))


@pytest.fixture(scope="module")
def described():
    """Keypoints of one scene described by the Pallas kernel (interpret
    mode, one shared run) and by the port's plain version."""
    img = _scene(3)
    atlas_t = tfeat.build_pyramid(torch.from_numpy(img).to(torch.float32), TORB)
    atlas = atlas_t.to(torch.float32).numpy()
    meta = tfeat.pyramid_meta(*img.shape, TORB)
    kps = tfeat.detect_pyramid(atlas_t, meta, TORB)
    lvl = kps.level.numpy()
    y_lo = np.asarray(meta.offsets, np.int32)[lvl]
    x_lo = np.asarray(meta.xoffsets, np.int32)[lvl]
    y_hi = y_lo + np.asarray([s[0] for s in meta.sizes], np.int32)[lvl]
    x_hi = x_lo + np.asarray([s[1] for s in meta.sizes], np.int32)[lvl]
    ys = kps.y.numpy() + y_lo
    xs = kps.x.numpy() + x_lo
    want = np.asarray(pallas_orb.orb_descriptors_pallas(
        jnp.asarray(atlas).astype(jnp.bfloat16), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(y_lo), jnp.asarray(y_hi), jnp.asarray(x_hi),
        ORB.descriptor_bits, ORB.pattern_seed, ORB.blur_ksize, ORB.blur_sigma,
        interpret=True, x_lo=jnp.asarray(x_lo), pass2="sublanes_loop",
    ))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    y0, x0 = cuda_orb.patch_origins(t(ys), t(xs), t(y_lo), t(y_hi), t(x_lo), t(x_hi))
    table = tfeat._level_tables(meta, TORB, torch.device("cpu"))[0]
    desc, bins, vals = cuda_orb.orb_describe_plain(
        atlas_t, kps.y, kps.x, kps.level, table, return_values=True
    )
    return dict(
        atlas=atlas, atlas_t=atlas_t, meta=meta, kps=kps, table=table, y0=y0.numpy(),
        x0=x0.numpy(), want=want, desc=desc.numpy(), bins=bins.numpy(), vals=vals.numpy(),
    )


def _kernel_origins(y, x, level, table):
    """The patch origins as orb.cu's ``origin_of`` forms them, one keypoint
    at a time in integers."""
    out = []
    for yk, xk, lk in zip(y, x, level):
        yo, xo, h, w = (int(v) for v in table[:, lk])
        out.append((min(max(int(yk) + yo - 31, yo), max(yo + h - 63, yo)),
                    min(max(int(xk) + xo - 31, xo), max(xo + w - 63, xo))))
    return np.array(out, np.int32).reshape(-1, 2).T


def test_brief_pattern_identical():
    for n, seed in ((256, 0x51DE0), (128, 7)):
        assert np.array_equal(torb.brief_pattern(n, seed), jorb.brief_pattern(n, seed))
    assert (torb.HALF_PATCH, torb.DESC_RADIUS, torb.PATCH) == (
        jorb.HALF_PATCH, jorb.DESC_RADIUS, jorb.PATCH,
    )


def test_bin_tables_and_masks_identical():
    a_j, d_j = pallas_orb._bin_tables(256, 0x51DE0, 7, 2.0)
    a_t, d_t = cuda_orb._bin_tables(256, 0x51DE0, 7, 2.0)
    assert np.array_equal(a_t, a_j) and np.array_equal(d_t, d_j)
    for t, j in zip(cuda_orb._moment_masks(), pallas_orb._moment_masks()):
        assert np.array_equal(t, j)


def test_tables_zero_outside_patch_and_compact_exactly():
    """The TPU window's rows and columns beyond the 63x63 patch carry zero
    weight, so the kernel reads only the patch; each row's (start, 8
    weights) form rebuilds the bf16-rounded dense row exactly."""
    a_win, d_win = pallas_orb._bin_tables(256, 0x51DE0, 7, 2.0)
    a_bf = np.asarray(jnp.asarray(a_win, jnp.bfloat16).astype(jnp.float32))
    d_bf = np.asarray(jnp.asarray(d_win, jnp.bfloat16).astype(jnp.float32))
    assert not a_bf[..., :4].any() and not a_bf[..., 4 + 63:].any()
    assert not d_bf[..., 63:].any()
    a, d, a_start, a_w, d_start, d_w = cuda_orb._patch_tables(256, 0x51DE0, 7, 2.0)
    assert np.array_equal(a, a_bf[..., 4:67]) and np.array_equal(d, d_bf[..., :63])
    for dense, start, w in ((a, a_start, a_w), (d, d_start, d_w)):
        rebuilt = np.zeros_like(dense)
        cols = start[..., None] + np.arange(8)
        np.put_along_axis(rebuilt, cols, w, axis=-1)
        assert np.array_equal(rebuilt, dense)


def test_sector32_identical_on_dense_grid():
    """Angles on and next to every sector boundary (f32 neighbours), at
    several magnitudes, plus the axes and the zero vector."""
    k = np.arange(64, dtype=np.float64)
    th = np.concatenate([k * np.pi / 32, np.random.RandomState(0).uniform(0, 2 * np.pi, 4000)])
    xs, ys = [], []
    for r in (1.0, 37.5, 1e3, 2.5e5, 3e6):
        x = (r * np.cos(th)).astype(np.float32)
        y = (r * np.sin(th)).astype(np.float32)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                xs.append(np.nextafter(x, np.float32(np.inf) * dx) if dx else x)
                ys.append(np.nextafter(y, np.float32(np.inf) * dy) if dy else y)
    x = np.concatenate(xs + [np.float32([0, 0, 5, -5, 0])])
    y = np.concatenate(ys + [np.float32([0, 5, 0, 0, -5])])
    # XLA on the CPU flushes subnormal floats to zero and torch does not;
    # moments of bf16 pixels against integer masks never reach that range.
    normal = lambda v: (v == 0) | (np.abs(v) >= np.finfo(np.float32).tiny)
    keep = normal(x) & normal(y)
    x, y = x[keep], y[keep]
    want = np.asarray(pallas_orb._sector32(jnp.asarray(x), jnp.asarray(y)))
    got = cuda_orb._sector32(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_plain_describe_matches_pallas_interpret(described):
    d = described
    k = len(d["y0"])
    assert k == ORB.max_keypoints and int(d["kps"].valid.sum()) > 100
    ref_bins = _ref_bins(d["atlas"], d["y0"], d["x0"])
    assert (d["bins"] == ref_bins).mean() >= 0.999
    agree = d["desc"] == d["want"]
    assert agree.mean() >= 0.995
    vals = d["vals"]
    margin = np.abs(vals[:, 256:] - vals[:, :256])
    assert agree[margin > 1.5].all()


def test_describe_features_match_jax_layout(described):
    """Compaction, masking of invalid slots and the level->level0 point map
    agree with the JAX describe (its descriptors differ on the CPU: the
    continuous-angle path)."""
    d = described
    meta_j = jfeat.pyramid_meta(240, 320, ORB)
    kps_j = jfeat.Keypoints(*(jnp.asarray(f.numpy()) for f in d["kps"]))
    for q in (128, 256):
        want = jfeat.describe(jnp.asarray(d["atlas"]).astype(jnp.bfloat16), meta_j, kps_j, q, ORB)
        got = tfeat.describe(d["atlas_t"], d["meta"], d["kps"], q, TORB)
        assert np.array_equal(got.pts.numpy(), np.asarray(want.pts))
        assert np.array_equal(got.score.numpy(), np.asarray(want.score))
        assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert not got.desc.numpy()[~got.valid.numpy()].any()


def test_kernel_origins_equal_patch_origins_of(described):
    """The kernel's origin arithmetic from (y, x, level, level table)
    equals ``features.patch_origins_of`` and the fixture's origins, formed
    from absolute centres and per-keypoint bounds as the TPU wrapper does."""
    d = described
    kps = d["kps"]
    y0, x0 = _kernel_origins(kps.y.numpy(), kps.x.numpy(), kps.level.numpy(), d["table"].numpy())
    of = tfeat.patch_origins_of(d["meta"], kps, TORB)
    assert np.array_equal(y0, of[0].numpy()) and np.array_equal(x0, of[1].numpy())
    assert np.array_equal(y0, d["y0"]) and np.array_equal(x0, d["x0"])


def test_padded_slots_clamp():
    """Padded keypoint slots (level bounds of the patch size, centers at
    the atlas corner) clamp inside the atlas, as in test_pallas_orb. Each
    keypoint's bounds are one level-table column of its own."""
    rng = np.random.RandomState(0)
    h, w = 140, 260
    atlas = (rng.rand(h, w) * 255).astype(np.float32)
    ys = np.array([0, 70, 0], np.int32)
    xs = np.array([0, 130, 0], np.int32)
    y_lo = np.zeros(3, np.int32)
    y_hi = np.array([h, h, 63], np.int32)
    x_lo = np.zeros(3, np.int32)
    x_hi = np.array([w, w, 63], np.int32)
    want = np.asarray(pallas_orb.orb_descriptors_pallas(
        jnp.asarray(atlas).astype(jnp.bfloat16), *map(jnp.asarray, (ys, xs, y_lo, y_hi, x_hi)),
        interpret=True, x_lo=jnp.asarray(x_lo), pass2="sublanes_loop",
    ))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    table = np.stack([y_lo, x_lo, y_hi - y_lo, x_hi - x_lo])
    level = np.arange(3, dtype=np.int32)
    y, x = ys - y_lo, xs - x_lo
    y0, x0 = cuda_orb.level_origins(t(y), t(x), t(level), t(table))
    assert y0.tolist() == [0, 39, 0] and x0.tolist() == [0, 99, 0]
    assert np.array_equal(_kernel_origins(y, x, level, table), [[0, 39, 0], [0, 99, 0]])
    desc, bins = cuda_orb.orb_describe(
        torch.from_numpy(atlas).to(torch.bfloat16), t(y), t(x), t(level), t(table)
    )
    assert set(np.unique(desc.numpy())) <= {-1, 1}
    assert (desc.numpy() == want).mean() >= 0.995
