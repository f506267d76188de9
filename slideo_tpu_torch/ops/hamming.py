"""Exact Hamming matching of +-1 descriptors: index, screening, best table.

Port of ``slideo_tpu/ops/hamming.py``. For +-1 vectors
hamming = (256 - <q, d>) / 2, so the table is a max/argmax of dot products
per (query, slide): kernel K5 (csrc/table.cu) on CUDA, the chunked matmul of
``hamming.py:307-358`` on the CPU. Decks above
``MatchConfig.screen_above_slides`` first go through stage-1 screening,
and the exact table then covers each frame's candidate slides only. Stage 1
has the JAX package's two rules: the batched one
(``screen_slides_batched``, kernel K5 mode (b), csrc/screen.cu, also in its
strided and listed forms for the optional pre-vote) and the per-frame one
(``screen_slides_frame``, the same kernel's prefix form, or K5 (a) over a
prefix above 128 bits). Everything here is bit-equal to the JAX package.

The SIFT engine's float counterparts (``hamming.py:392-456``, ``:641-700``)
are plain products, as the JAX package leaves them to XLA:
``match_table_float`` (the f32 best and per-slide second-best table of unit
descriptors) and ``screen_slides_float`` (its bf16 stage-1 vote).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig
from . import top_k
from .cuda_screen import SCREEN_BITS, screen_scores
from .cuda_table import match_table_scores

__all__ = [
    "DescriptorIndex",
    "MatchTable",
    "build_index",
    "pack_bits",
    "unpack_bits",
    "pack_descriptor_bits",
    "unpack_descriptor_bits",
    "match_table",
    "match_table_frame",
    "match_table_float",
    "screen_queries",
    "screen_slides_batched",
    "screen_slides_frame",
    "screen_slides_float",
]

_NEG = -(2**30)   # the score of an invalid slot in the float table


class DescriptorIndex(NamedTuple):
    """Flattened multi-slide descriptor index.

    desc [N, D] int8 (+-1; zeros on invalid slots), N = n_slides * K;
    slide_ids / train_ids [N] int32; valid [N] bool. ``desc_t`` and
    ``screen_desc`` are the TPU kernels' layouts; the CUDA table and
    screening kernels read ``desc`` row-major, so the port leaves both None.
    """

    desc: torch.Tensor
    slide_ids: torch.Tensor
    train_ids: torch.Tensor
    valid: torch.Tensor
    desc_t: torch.Tensor | None = None
    screen_desc: torch.Tensor | None = None


class MatchTable(NamedTuple):
    """Per-(query, slide) best match: dist [Q, S] float32 best hamming
    distance, train [Q, S] int32 arg-best slot (first on ties), slide_ids
    [S] int32, valid [Q, S] bool (slide has a valid descriptor)."""

    dist: torch.Tensor
    train: torch.Tensor | None
    slide_ids: torch.Tensor
    valid: torch.Tensor
    dist2: torch.Tensor | None = None


def build_index(slide_desc: torch.Tensor, slide_valid: torch.Tensor) -> DescriptorIndex:
    """Index of per-slide descriptors [S, K, D] and validity [S, K]."""
    s, k, d = slide_desc.shape
    dev = slide_desc.device
    valid = slide_valid.reshape(s * k)
    desc = torch.where(valid[:, None], slide_desc.reshape(s * k, d), 0).to(torch.int8)
    slide_ids = torch.arange(s, dtype=torch.int32, device=dev).repeat_interleave(k)
    train_ids = torch.arange(k, dtype=torch.int32, device=dev).repeat(s)
    return DescriptorIndex(desc.contiguous(), slide_ids, train_ids, valid.contiguous())


def _msb_first(device: torch.device) -> torch.Tensor:
    """Bit shifts of one byte, most significant first, as np.packbits packs."""
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] of 0/1 -> [..., ceil(n/8)] uint8, zero-padded at the end."""
    pad = -bits.shape[-1] % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.to(torch.uint8).reshape(*bits.shape[:-1], -1, 8)
    return (bits << _msb_first(bits.device)).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: [..., m] uint8 -> [..., n] uint8 of 0/1
    (n <= 8m)."""
    bits = (packed[..., None] >> _msb_first(packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n]


def pack_descriptor_bits(
    desc: torch.Tensor, valid: torch.Tensor, s: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """np.packbits on the device (``hamming.py:110-134``): the index's desc
    [S*K, D] (bit = value > 0) and valid [S*K] -> desc_bits [S, K, D/8]
    uint8 and valid_bits [S, ceil(K/8)] uint8, MSB first."""
    desc_bits = pack_bits((desc > 0).reshape(s, k, -1))
    return desc_bits, pack_bits(valid.reshape(s, k))


def unpack_descriptor_bits(
    desc_bits: torch.Tensor, valid_bits: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """np.unpackbits on the device (``hamming.py:85-107``), the inverse of
    ``pack_descriptor_bits``: desc [S, K, D] int8 in {-1, +1} and valid
    [S, K] bool, the inputs of ``build_index``."""
    d = desc_bits.shape[-1] * 8
    desc = unpack_bits(desc_bits, d).to(torch.int8) * 2 - 1
    return desc, unpack_bits(valid_bits, k).to(torch.bool)


def match_table(
    query: torch.Tensor,
    index: DescriptorIndex,
    n_slides: int,
    k_per_slide: int,
    slide_ids: torch.Tensor | None = None,
) -> MatchTable:
    """The exact best-match table (with arg-best train slots) over all
    ``n_slides`` slides of the index, or over the slides ``slide_ids`` ([C]
    int32). Unlike the JAX function, which takes a sub-index copied for
    those slides, the port reads their rows in place."""
    q, d_bits = query.shape
    best, arg = match_table_scores(
        query, index.desc, index.valid, n_slides, k_per_slide, slide_ids
    )
    svalid = index.valid.reshape(n_slides, k_per_slide).any(dim=1)
    if slide_ids is None:
        slide_ids = torch.arange(n_slides, dtype=torch.int32, device=query.device)
    else:
        svalid = svalid[slide_ids.long()]
    return MatchTable(
        dist=(d_bits - best) * 0.5,
        train=arg,
        slide_ids=slide_ids,
        valid=svalid[None, :].expand(q, slide_ids.shape[0]),
    )


def screen_queries(
    desc: torch.Tensor, score: torch.Tensor, valid: torch.Tensor, cfg: MatchConfig
) -> torch.Tensor:
    """A frame's ``cfg.screen_queries`` strongest descriptor rows [Qs, D]:
    stable top-k of ``where(valid, score, -1)``, lowest index first on ties
    (``orb_matcher.py:395-397``). Invalid rows are all zero and may be among
    them, unmasked, as on the TPU; a frame with fewer rows is padded with
    zero rows, as the JAX package pads its features to max_keypoints."""
    n = cfg.screen_queries
    pad = n - desc.shape[0]
    key = torch.where(valid, score, -1.0)
    if pad > 0:
        desc = torch.cat([desc, desc.new_zeros((pad, desc.shape[1]))])
        key = torch.cat([key, key.new_full((pad,), -1.0)])
    return desc[top_k(key, n)[1]]


def _screen_votes(best: torch.Tensor) -> torch.Tensor:
    """[..., Qs, S] stage-1 scores -> [..., S] float32 votes (``votes_of``,
    ``hamming.py:539-545``): a query keeps every slide within 5% + 1 bit of
    its best prefix distance, in float32 as the JAX package computes it."""
    dist = (SCREEN_BITS - best.to(torch.float32)) * 0.5
    bestd = dist.amin(dim=-1, keepdim=True)
    keep = dist <= bestd * 1.05 + 1.0
    return keep.sum(dim=-2).to(torch.float32)


def screen_slides_batched(
    qdesc: torch.Tensor,
    index: DescriptorIndex,
    n_slides: int,
    k_per_slide: int,
    cfg: MatchConfig,
) -> torch.Tensor:
    """Stage-1 candidate slides of a batch of frames (``hamming.py:492-605``).

    qdesc [B, Qs, D] int8: each frame's ``screen_queries`` rows, strongest
    first. Returns [B, C] int32, C = ``min(cfg.screen_slides, n_slides)``.

    Single stage: all frames' 128-bit prefixes (whatever ``screen_bits``
    says, as in the JAX package) stack into one [B*Qs, 128]
    screening call over every slot of every slide (full K); each frame's
    candidates are the stable top C of its votes.

    With ``cfg.screen_prevote``, when the deck has more than
    P = ``screen_prevote_slides`` slides and K is a multiple of 128 *
    ``screen_prevote_k_stride``: (1a) each frame's strongest
    ``screen_prevote_queries`` prefixes vote over every stride-th slot of
    every slide and keep their top P slides; (1b) all Qs prefixes of each
    frame vote again over full K of its own P slides only (the survivors'
    own best-distance threshold), and the candidates are those slides in
    the order of the re-vote's stable top C: ties fall to the earlier
    position in the pre-vote's list, not to the lower slide id.

    ``screen_k_per_slide`` is not read either: the JAX package's batched path
    ignores both (``orb_matcher.match_frames`` routes the other settings to
    ``screen_slides_frame``).
    """
    b, qs, _ = qdesc.shape
    prefixes = qdesc[..., :SCREEN_BITS]
    flat = prefixes.reshape(b * qs, SCREEN_BITS).contiguous()
    c_out = min(cfg.screen_slides, n_slides)
    p, stride = cfg.screen_prevote_slides, cfg.screen_prevote_k_stride
    # JAX's guard (hamming.py:547-551) comes from the TPU kernel's lane
    # geometry (128-slot tiles), not from the math; kept because it decides
    # which rule runs, and so the candidates.
    if cfg.screen_prevote and n_slides > p and k_per_slide % (128 * stride) == 0:
        npq = min(cfg.screen_prevote_queries, qs)
        strong = prefixes[:, :npq].reshape(b * npq, SCREEN_BITS).contiguous()
        best = screen_scores(strong, index.desc, index.valid, n_slides, k_per_slide, stride=stride)
        pre = top_k(_screen_votes(best.reshape(b, npq, n_slides)), p)[1].to(torch.int32)
        best = screen_scores(flat, index.desc, index.valid, n_slides, k_per_slide, slide_ids=pre)
        order = top_k(_screen_votes(best.reshape(b, qs, p)), c_out)[1]
        return torch.gather(pre, 1, order)
    best = screen_scores(flat, index.desc, index.valid, n_slides, k_per_slide)
    votes = _screen_votes(best.reshape(b, qs, n_slides))
    return top_k(votes, c_out)[1].to(torch.int32)


def screen_slides_frame(
    query: torch.Tensor,
    query_score: torch.Tensor,
    index: DescriptorIndex,
    n_slides: int,
    k_per_slide: int,
    cfg: MatchConfig,
) -> torch.Tensor:
    """Stage-1 candidate slides [min(cfg.screen_slides, n_slides)] int32 of
    one frame by the JAX package's per-frame rule (``_screen_slides``,
    ``hamming.py:733-782``).

    The ``cfg.screen_queries`` rows of ``query`` [Q, D] with the highest raw
    ``query_score`` (stable, lowest index first; invalid rows are not
    masked, and a frame of fewer rows gives them all) vote with their
    ``bits = min(screen_bits, D)``-bit prefixes over the first ``ksk =
    min(screen_k_per_slide, K)`` slots of every slide, read in place (the
    JAX package gathers a prefix index): K5 (b)'s prefix form up to 128
    bits, K5 (a) above, the query zero past the prefix. A query keeps every
    slide with a valid slot among those ``ksk`` whose best prefix distance
    lies within 5% + 1 bit of its best such slide's; the candidates are the
    stable top of the float32 votes.
    """
    _, top_q = top_k(query_score, min(cfg.screen_queries, query.shape[0]))
    d_bits = query.shape[1]
    bits = min(cfg.screen_bits, d_bits)
    ksk = min(cfg.screen_k_per_slide, k_per_slide)
    q_sub = query[top_q, :bits].contiguous()
    if bits <= SCREEN_BITS:
        best = screen_scores(q_sub, index.desc, index.valid, n_slides, k_per_slide, n_slots=ksk)
    else:
        q_pad = torch.nn.functional.pad(q_sub, (0, d_bits - bits))
        best, _ = match_table_scores(
            q_pad, index.desc, index.valid, n_slides, k_per_slide, n_slots=ksk
        )
    dist = (bits - best.to(torch.float32)) * 0.5
    svalid = index.valid.reshape(n_slides, k_per_slide)[:, :ksk].any(dim=1)
    bestd = torch.where(svalid, dist, torch.inf).amin(dim=1, keepdim=True)
    keep = svalid & (dist <= bestd * 1.05 + 1.0)
    votes = keep.sum(dim=0).to(torch.float32)
    return top_k(votes, min(cfg.screen_slides, n_slides))[1].to(torch.int32)


def match_table_frame(
    query: torch.Tensor,
    query_score: torch.Tensor,
    index: DescriptorIndex,
    n_slides: int,
    k_per_slide: int,
    cfg: MatchConfig,
) -> MatchTable:
    """Frame-level table (``hamming.py:612-638``): the exact table over
    every slide for decks of at most ``cfg.screen_above_slides`` slides;
    above that, the frame's stage-1 candidates by the per-frame rule
    (``screen_slides_frame``) and the exact table over those columns, read
    in place."""
    if n_slides <= cfg.screen_above_slides:
        return match_table(query, index, n_slides, k_per_slide)
    cand = screen_slides_frame(query, query_score, index, n_slides, k_per_slide, cfg)
    return match_table(query, index, n_slides, k_per_slide, slide_ids=cand)


_TABLE_CHUNK = 8    # match_table_float's slides per product (JAX hamming.py:398)
_SCREEN_CHUNK = 16  # screen_slides_float's slides per product (JAX hamming.py:649)


def _slide_chunks(
    desc: torch.Tensor, valid: torch.Tensor, n_slides: int, k_per_slide: int,
    slide_ids: torch.Tensor | None, chunk_slides: int,
):
    """The rows of ``slide_ids`` (all slides when None) in chunks of
    ``chunk_slides`` slides: ([chunk_slides * K, D], [chunk_slides, K])
    pairs read in place; the last chunk is padded with invalid zero slides,
    as the JAX scan pads, so every product has one shape."""
    d_dim = desc.shape[-1]
    desc3 = desc.reshape(n_slides, k_per_slide, d_dim)
    valid3 = valid.reshape(n_slides, k_per_slide)
    n_cols = n_slides if slide_ids is None else slide_ids.shape[0]
    chunk_slides = max(1, min(chunk_slides, n_cols))
    for c0 in range(0, n_cols, chunk_slides):
        c1 = min(c0 + chunk_slides, n_cols)
        if slide_ids is None:
            d, v = desc3[c0:c1], valid3[c0:c1]
        else:
            cols = slide_ids[c0:c1].long()
            d, v = desc3[cols], valid3[cols]
        pad = chunk_slides - (c1 - c0)
        if pad:
            d = torch.cat([d, d.new_zeros((pad, k_per_slide, d_dim))])
            v = torch.cat([v, v.new_zeros((pad, k_per_slide))])
        yield d.reshape(-1, d_dim), v, c1 - c0


def match_table_float(
    query: torch.Tensor,
    desc: torch.Tensor,
    valid: torch.Tensor,
    n_slides: int,
    k_per_slide: int,
    slide_ids: torch.Tensor | None = None,
) -> MatchTable:
    """Best-match table of float (SIFT) descriptors over all ``n_slides``
    slides of desc [S*K, D] / valid [S*K], or over the slides ``slide_ids``
    ([C] int32, read in place where the JAX package copies them out).

    query [Q, D] f32 unit vectors. Per (query, slide): the best dot over the
    slide's valid slots (invalid slots score ``_NEG``), its first argmax and
    the second best with that slot masked, as
    dist = sqrt(max(2 - 2 * dot, 0)); a slide with one valid slot gets its
    dist2 from ``_NEG`` (no second neighbour: Lowe's ratio passes). An f32
    ``torch.matmul`` per chunk of ``_TABLE_CHUNK`` slides, as the JAX scan
    chunks: the whole [2048, 250 x 2048] product would take 4.2 GB.
    """
    q = query.shape[0]
    best, arg, second = [], [], []
    for d, v, n in _slide_chunks(desc, valid, n_slides, k_per_slide, slide_ids, _TABLE_CHUNK):
        scores = torch.matmul(query, d.T).reshape(q, v.shape[0], k_per_slide)
        scores = torch.where(v[None], scores, float(_NEG))
        b, a = scores.max(dim=-1)                       # first argmax
        k_iota = torch.arange(k_per_slide, device=query.device)
        s2 = torch.where(k_iota == a[..., None], float(_NEG), scores).amax(dim=-1)
        best.append(b[:, :n])
        arg.append(a[:, :n])
        second.append(s2[:, :n])
    best, arg, second = (torch.cat(x, dim=1) for x in (best, arg, second))
    svalid = valid.reshape(n_slides, k_per_slide).any(dim=1)
    if slide_ids is None:
        slide_ids = torch.arange(n_slides, dtype=torch.int32, device=query.device)
    else:
        svalid = svalid[slide_ids.long()]
    return MatchTable(
        dist=torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0)),
        train=arg.to(torch.int32),
        slide_ids=slide_ids,
        valid=svalid[None, :].expand(q, slide_ids.shape[0]),
        dist2=torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=0.0)),
    )


def screen_slides_float(
    query: torch.Tensor,
    query_score: torch.Tensor,
    desc: torch.Tensor,
    valid: torch.Tensor,
    n_slides: int,
    k_per_slide: int,
    cfg: MatchConfig,
) -> torch.Tensor:
    """Stage-1 candidate slides [min(cfg.screen_slides, n_slides)] int32 of
    one frame's float (SIFT) descriptors (``hamming.py:641-700``).

    The ``cfg.screen_queries`` strongest queries by ``query_score`` vote
    for every slide whose best dot lies within 5% + 0.05 (unit-vector L2)
    of the query's best slide. Queries and descriptors are rounded to bf16
    and multiplied as f32, as the JAX package asks its bf16 product for an
    f32 result (a bf16 ``torch.matmul`` would round the result to bf16).
    """
    _, top_q = top_k(query_score, min(cfg.screen_queries, query.shape[0]))
    q_sub = query[top_q].to(torch.bfloat16).to(torch.float32)
    qs = q_sub.shape[0]
    best = []
    for d, v, n in _slide_chunks(desc, valid, n_slides, k_per_slide, None, _SCREEN_CHUNK):
        d = d.to(torch.bfloat16).to(torch.float32)
        dots = torch.matmul(q_sub, d.T).reshape(qs, v.shape[0], k_per_slide)
        best.append(torch.where(v[None], dots, -2.0).amax(dim=-1)[:, :n])
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * torch.cat(best, dim=1), min=0.0))
    bestd = dist.amin(dim=1, keepdim=True)
    keep = dist <= bestd * 1.05 + 0.05
    votes = keep.sum(dim=0).to(torch.float32)
    return top_k(votes, min(cfg.screen_slides, n_slides))[1].to(torch.int32)
