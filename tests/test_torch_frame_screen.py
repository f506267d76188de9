"""The per-frame stage-1 rule (``hamming.screen_slides_frame``) against the
JAX package's ``_screen_slides`` on the CPU.

The JAX package takes that rule where its batched one does not run: in
``match_table_frame`` (one frame above ``screen_above_slides``) and in
``match_frames`` when ``screen_bits`` is not 128 or the index has no
screening tensor (K not a multiple of 128; on the CPU never). At CPU sizes
its table takes the XLA path, the one ``screen_bits = 64`` takes on the
TPU; the TPU kernel's own call (``hamming.py:288``, 128 bits over 128
slots) runs here in interpret mode. Same numpy inputs through both
packages, exact equality throughout:

(i)   ``screen_slides_frame`` == ``_screen_slides`` at (K, ksk, bits) =
      (384, 128, 128), (384, 384, 64), (200, 200, 96), (256, 100, 200):
      trimmed and full K, 64- and 128-bit prefixes, a width that pads to
      128 and one above 128 (K5 (a) over the prefix), a slide whose first
      ksk slots are invalid and later ones valid, invalid query rows with
      the highest scores, and a deck of 10 slides repeated 4 times, so
      votes tie in groups.
(ii)  The prefix table under the vote (K5 (b)'s prefix form, or K5 (a) at
      n_slots), plain versions, == JAX's table over its gathered prefix
      index, and at 128 bits x 128 slots == the interpret-mode Pallas
      kernel.
(iii) ``match_table_frame`` == JAX's with no screening tensor: dist, train,
      slide_ids and valid.
(iv)  ``match_frames`` == ``jom.match_frames``: on the K = 200 deck of
      ``test_torch_screen.py`` trimmed to ``screen_k_per_slide`` = 128, and
      on its 100-slide deck at ``screen_bits`` = 64 (the JAX package ignores
      the deck's screening tensor there).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.models import orb_matcher as jom
from slideo_tpu.ops import hamming as jham
from slideo_tpu.ops.pallas_table import match_table_scores_pallas
from slideo_tpu_torch.models import orb_matcher as tom
from slideo_tpu_torch.ops import cuda_screen, cuda_table
from slideo_tpu_torch.ops import hamming as tham
from test_torch_config import port_cfg
from test_torch_screen import HW, deck100_inputs, k200_inputs

torch.set_num_threads(1)

CASES = [(384, 128, 128), (384, 384, 64), (200, 200, 96), (256, 100, 200)]


def _pm1(rng, *shape) -> np.ndarray:
    return np.where(rng.rand(*shape) > 0.5, 1, -1).astype(np.int8)


def _frame_case(k: int, ksk: int, bits: int):
    """A 40-slide index (10 slides repeated 4 times; slide 5 valid only past
    its first ksk slots) and a frame of 300 rows, 200 of them near slide 3's
    first ksk slots, 30 invalid (zero) rows carrying the highest scores;
    the config at (ksk, bits)."""
    rng = np.random.RandomState(k + ksk + bits)
    desc = np.tile(_pm1(rng, 10, k, 256), (4, 1, 1))
    valid = np.tile(rng.rand(10, k) > 0.2, (4, 1))
    valid[5, :ksk] = False
    valid[5, ksk:] = True
    near = desc[3, rng.choice(ksk, 200)].copy()
    for row in near:
        row[rng.choice(bits, max(1, bits // 10), replace=False)] *= -1
    query = np.concatenate([near, _pm1(rng, 100, 256)])
    score = rng.rand(300).astype(np.float32)
    invalid = rng.choice(300, 30, replace=False)
    query[invalid] = 0
    score[invalid] += 1.0
    cfg = dataclasses.replace(DEFAULT_CONFIG.match, screen_bits=bits, screen_k_per_slide=ksk)
    return desc, valid, query, score, cfg


@pytest.mark.parametrize("k, ksk, bits", CASES)
def test_screen_slides_frame_equals_jax(k, ksk, bits):
    desc, valid, query, score, cfg = _frame_case(k, ksk, bits)
    s = desc.shape[0]
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    want = np.asarray(jham._screen_slides(jnp.asarray(query), jnp.asarray(score), ji, s, cfg))
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    got = tham.screen_slides_frame(torch.from_numpy(query), torch.from_numpy(score), ti, s, k,
                                   port_cfg(cfg))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got[:4].tolist() == [3, 13, 23, 33]   # a tie of 4 copies, lowest id first


@pytest.mark.parametrize("k, ksk, bits", CASES)
def test_prefix_table_equals_jax(k, ksk, bits):
    """The table under the vote: the plain version of the kernel that
    ``screen_slides_frame`` launches (K5 (b)'s prefix form up to 128 bits,
    K5 (a) over the first ksk slots above) against JAX's table over the
    prefix index ``_screen_slides`` gathers (``hamming.py:757-777``)."""
    desc, valid, query, score, _ = _frame_case(k, ksk, bits)
    s = desc.shape[0]
    q_sub = query[np.argsort(-score, kind="stable")[:256], :bits]
    prefix = jham.DescriptorIndex(
        desc=jnp.asarray(desc[:, :ksk, :bits].reshape(-1, bits)),
        slide_ids=jnp.repeat(jnp.arange(s, dtype=jnp.int32), ksk),
        train_ids=jnp.tile(jnp.arange(ksk, dtype=jnp.int32), s),
        valid=jnp.asarray(valid[:, :ksk].reshape(-1)),
    )
    want = jham.match_table(jnp.asarray(q_sub), prefix, s, ksk, chunk_slides=16, with_train=False)
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    tq = torch.from_numpy(np.ascontiguousarray(q_sub))
    if bits <= cuda_screen.SCREEN_BITS:
        best = cuda_screen.screen_scores(tq, ti.desc, ti.valid, s, k, n_slots=ksk).to(torch.float32)
    else:
        tq = torch.nn.functional.pad(tq, (0, 256 - bits))
        best, _ = cuda_table.match_table_scores(tq, ti.desc, ti.valid, s, k, n_slots=ksk)
    svalid = valid[:, :ksk].any(axis=1)
    assert np.array_equal(np.asarray(want.valid)[0], svalid) and not svalid[5]
    dist = ((bits - best) * 0.5).numpy()
    assert np.array_equal(dist[:, svalid], np.asarray(want.dist)[:, svalid])
    assert (best[:, ~svalid] == -254 if bits <= 128 else best[:, ~svalid] == -(2**30)).all()
    if bits % 128 == 0 and ksk % 128 == 0:
        # The TPU kernel as _screen_slides reaches it: int8, transposed,
        # max-only, a -1e6 bias on invalid slots.
        desc_t = np.swapaxes(desc, 1, 2)[:, :bits, :ksk]
        bias = np.where(valid[:, :ksk], 0.0, -1e6).astype(np.float32).reshape(-1)
        pallas, _ = match_table_scores_pallas(
            jnp.asarray(q_sub), jnp.asarray(np.ascontiguousarray(desc_t)), jnp.asarray(bias), s,
            ksk, with_arg=False, dtype=jnp.int8, transposed=True, interpret=True,
        )
        assert np.array_equal(best.numpy()[:, svalid], np.asarray(pallas)[:, svalid])


@pytest.mark.parametrize("ksk, bits", [(128, 128), (384, 64)])
def test_match_table_frame_equals_jax(ksk, bits):
    desc, valid, query, score, cfg = _frame_case(384, ksk, bits)
    s, k = desc.shape[:2]
    cfg = dataclasses.replace(cfg, screen_above_slides=8)
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    assert ji.screen_desc is None
    want = jham.match_table_frame(jnp.asarray(query), jnp.asarray(score), ji, s, k, cfg)
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    got = tham.match_table_frame(torch.from_numpy(query), torch.from_numpy(score), ti, s, k,
                                 port_cfg(cfg))
    assert got.dist.shape == (300, cfg.screen_slides)
    for name in ("dist", "train", "slide_ids", "valid"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name


def test_match_frames_trimmed_at_k_not_a_multiple_of_128():
    """The K = 200 deck with ``screen_k_per_slide`` = 128: both packages
    screen frame by frame over the first 128 slots of each slide."""
    cfg, frames, ji, ti = k200_inputs()
    cfg = dataclasses.replace(cfg, match=dataclasses.replace(cfg.match, screen_k_per_slide=128))
    seeds = list(range(len(frames)))
    want = jom.match_frames(jnp.asarray(frames), jnp.asarray(seeds, jnp.int32), ji, HW, cfg)
    got = tom.match_frames(torch.from_numpy(frames), seeds, ti, HW, port_cfg(cfg))
    assert got.slide.tolist() == np.asarray(want.slide).tolist()
    assert got.slide.tolist()[-1] == -1 and sum(s >= 0 for s in got.slide.tolist()) >= 4


def test_match_frames_at_64_bits_on_the_100_slide_deck():
    """The 100-slide deck at ``screen_bits`` = 64: the JAX package takes its
    per-frame rule although the index carries a screening tensor, and so
    does the port."""
    cfg, _, frames, ji = deck100_inputs(screen_bits=64)
    di = ji.desc_index
    assert di.screen_desc is not None
    ti = tom.slide_index_from_numpy(
        np.asarray(di.desc), np.asarray(di.valid), np.asarray(ji.pts), np.asarray(ji.smalls),
        device="cpu",
    )
    seeds = list(range(len(frames)))
    want = jom.match_frames(jnp.asarray(frames), jnp.asarray(seeds, jnp.int32), ji, HW, cfg)
    got = tom.match_frames(torch.from_numpy(frames), seeds, ti, HW, port_cfg(cfg))
    assert got.slide.tolist() == np.asarray(want.slide).tolist()
    assert min(got.slide.tolist()) >= 0
