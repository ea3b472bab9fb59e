"""Word-level timestamps: DTW over decoder cross-attention.

Port of ``whisper_tpu/align.py``. The semantics follow OpenAI Whisper's
``word_timestamps=True`` (whisper/timing.py, MIT):

- ONE batched teacher-forced decoder pass over the decoded sequences
  returns every layer's cross-attention probabilities
  (:func:`alignment_cross_attn`), or reduces them on the device to the
  (B, S, Ta) alignment matrix (:func:`alignment_matrix`: standardization
  over the text rows, a median filter along time, the alignment-head mean),
  so only that matrix and the per-token log-probabilities reach the host;
- the O(S*T) DTW and the word grouping run on the host in numpy, on the
  cropped (text rows x audio frames) matrix: :func:`words_from_matrix`.

The pass is plain PyTorch (matmuls, softmax, the sorting network of the
median): the JAX function reaches no Pallas kernel, so there is no kernel to
port here. It runs on the device of the model and the cross-KV.

Under a :class:`~whisper_tpu_torch.models.model.ShardedWhisper` the pass
runs rank by rank over each rank's local heads, as ``decoder_forward`` does:
:func:`alignment_matrix` sums each rank's head-masked sum of the filtered
maps on the lead device and divides once by the whole mask's count (JAX
gets the same from XLA's one cross-shard reduction);
:func:`alignment_cross_attn` concatenates the ranks' heads in rank order.
Under a :class:`~whisper_tpu_torch.models.model.DataParallelWhisper` each
data row runs the pass on its block of the batch and the results are
gathered on the lead device.

Alignment-head selection: by default all heads of the last half of the
decoder layers (OpenAI's default for a model without a stored mask). Exact
per-model masks come from a JSON sidecar (``WHISPER_TPU_ALIGNMENT_HEADS``
or ``alignment_heads=``).
"""

from __future__ import annotations

import copy
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import HOP_LENGTH, SAMPLE_RATE, WhisperConfig
from .models.model import (
    NEG,
    DataParallelWhisper,
    DataRows,
    Shards,
    _column,
    _embed,
    _gather,
    _gelu,
    _merge_heads,
    _model_logits,
    _row_blocks,
    _row_parallel,
    _row_values,
    _split_heads,
    _to,
    layer_norm,
    model_shards,
    shard_values,
)

# seconds per decoder audio frame: the encoder halves the mel frames (conv2
# stride 2) and the mel hop is 160 samples
TIME_PER_FRAME = 2 * HOP_LENGTH / SAMPLE_RATE  # 0.02 s

# scripts without spaces between words: split per codepoint run, and no
# punctuation merge
UNSPACED = ("zh", "ja", "th", "lo", "my", "yue")


# --------------------------------------------------------------- device pass
def _teacher_forced(model, tokens: torch.Tensor, cross_kv, compute_dtype, gelu: str,
                    on_cross) -> torch.Tensor:
    """The teacher-forced decoder over ``tokens`` (B, S) at positions 0..S-1
    against the float cross-KV; calls ``on_cross(layer, rank, w)`` with each
    rank's (B, H_local, S, Ta) fp32 cross-attention softmax. Returns the
    (B, S-1) fp32 log P(tokens[:, i + 1] | tokens[:, :i + 1])."""
    cfg = model.cfg
    shards = model_shards(model)
    dec = shards[0].decoder
    dt = compute_dtype
    B, S = tokens.shape
    n_head = cfg.n_text_head // len(shards)
    dh = cfg.head_dim_text
    crosses = shard_values(cross_kv)
    x = _embed(model, tokens).to(dt) + dec.pos_emb[:S].to(dt)[None]
    causal = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()[None, None]
    causal_r = {}
    for layer in range(cfg.n_text_layer):
        blks = [s.decoder.blocks[layer] for s in shards]
        b0 = blks[0]
        h = layer_norm(x, b0.attn_ln["g"], b0.attn_ln["b"])
        outs = []
        for q, k, v in _column(h, [[(blk.attn["wq"], blk.attn["bq"]), (blk.attn["wk"], None),
                                    (blk.attn["wv"], blk.attn["bv"])] for blk in blks], dt):
            qh, kh, vh = (_split_heads(t, n_head) for t in (q, k, v))
            mask = causal_r.setdefault(q.device, _to(causal, q.device))
            s = torch.matmul(qh.to(torch.float32), kh.to(torch.float32).transpose(-1, -2))
            s = torch.where(mask, s * (dh ** -0.5), torch.full_like(s, NEG))
            outs.append(_merge_heads(torch.matmul(torch.softmax(s, dim=-1).to(dt), vh)))
        x = x + _row_parallel(outs, [blk.attn["wo"] for blk in blks], b0.attn["bo"], dt)

        h = layer_norm(x, b0.cross_ln["g"], b0.cross_ln["b"])
        outs = []
        for rank, (ckv, (q,)) in enumerate(zip(crosses, _column(
                h, [[(blk.cross["wq"], blk.cross["bq"])] for blk in blks], dt))):
            qh = _split_heads(q, n_head)
            ck, cv = ckv[0][layer].to(dt), ckv[1][layer].to(dt)
            sc = torch.matmul(qh.to(torch.float32), ck.to(torch.float32).transpose(-1, -2))
            w = torch.softmax(sc * (dh ** -0.5), dim=-1)  # (B, H, S, Ta) fp32
            outs.append(_merge_heads(torch.matmul(w.to(dt), cv)))
            on_cross(layer, rank, w)
        x = x + _row_parallel(outs, [blk.cross["wo"] for blk in blks], b0.cross["bo"], dt)

        h = layer_norm(x, b0.mlp_ln["g"], b0.mlp_ln["b"])
        hs = [_gelu(y, gelu) for (y,) in
              _column(h, [[(blk.mlp["w1"], blk.mlp["b1"])] for blk in blks], dt)]
        x = x + _row_parallel(hs, [blk.mlp["w2"] for blk in blks], b0.mlp["b2"], dt)

    x = layer_norm(x, dec.ln["g"], dec.ln["b"])
    logits = _model_logits(model, x, dt)  # (B, S, n_vocab) fp32
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return torch.gather(logp, 2, tokens[:, 1:, None].to(torch.int64))[..., 0]


@torch.no_grad()
def alignment_cross_attn(model, tokens: torch.Tensor, cross_kv,
                         compute_dtype=torch.float32, gelu: str = "erf"):
    """Teacher-forced decoder pass returning cross-attention probabilities.

    ``tokens`` (B, S) are full teacher-forced sequences and ``cross_kv`` the
    float 2-tuple (L, B, H, Ta, dh) (:func:`dequantize_cross_kv` for the
    int8 one; :class:`Shards` of each rank's under a mesh). Returns (attn
    (L, B, H, S, Ta) fp32, softmax over Ta, and token_logprobs (B, S-1) fp32,
    log P(tokens[:, i+1] | tokens[:, :i+1]), used for per-word confidence).
    """
    if isinstance(model, DataParallelWhisper):
        outs = [alignment_cross_attn(m, t, c, compute_dtype, gelu)
                for m, t, c in zip(model.rows, _row_blocks(model, tokens),
                                   _row_values(model, cross_kv, "cross_kv"))]
        return (torch.cat([_to(a, model.device) for a, _ in outs], dim=1),
                _gather(model, [t for _, t in outs]))
    L, R = model.cfg.n_text_layer, len(model_shards(model))
    maps = [[None] * R for _ in range(L)]

    def keep(layer, rank, w):
        maps[layer][rank] = w

    tlp = _teacher_forced(model, tokens, cross_kv, compute_dtype, gelu, keep)
    lead = tokens.device
    attn = torch.stack([torch.cat([_to(w, lead) for w in ranks], dim=1) for ranks in maps])
    return attn, tlp


_MEDIAN7 = ((1, 2), (3, 4), (5, 6), (0, 2), (3, 5), (4, 6), (0, 1), (4, 5), (2, 6), (0, 4),
            (1, 5), (0, 3), (2, 5), (1, 3), (2, 4), (2, 3))


def _median_taps(taps: List[torch.Tensor]) -> torch.Tensor:
    """Element-wise median of an odd number of same-shaped tensors: seven
    through the 16-comparator sorting network (``_MEDIAN7``; after it
    ``a[3]`` is the median), any other count by sorting their stack."""
    a = list(taps)
    if len(a) != 7:
        return torch.sort(torch.stack(a, dim=-1), dim=-1).values[..., len(a) // 2]
    for i, j in _MEDIAN7:
        a[i], a[j] = torch.minimum(a[i], a[j]), torch.maximum(a[i], a[j])
    return a[3]


def _reflect_taps(frame_len: torch.Tensor, Ta: int, width: int) -> torch.Tensor:
    """(B, Ta, width) int64 gather indices of a reflect-padded sliding
    window along time whose boundary sits at each row's audio end
    (``frame_len``), as the host path crops and then filters."""
    half = width // 2
    dev = frame_len.device
    t = torch.arange(Ta, device=dev)[None, :, None]
    k = torch.arange(width, device=dev)[None, None, :] - half
    n = torch.clamp(frame_len.to(torch.int64), min=1)[:, None, None]
    j = torch.abs(t + k)                                    # reflect at 0
    j = torch.minimum(j, 2 * (n - 1))                       # clamp tiny n
    j = (n - 1) - torch.abs((n - 1) - j)                    # reflect at n-1
    return torch.clamp(j, 0, Ta - 1)


@torch.no_grad()
def alignment_matrix(model, tokens: torch.Tensor, cross_kv, head_mask: torch.Tensor,
                     row_mask: torch.Tensor, frame_len: torch.Tensor,
                     compute_dtype=torch.float32, medfilt_width: int = 7,
                     gelu: str = "erf"):
    """Teacher-forced pass returning the device-reduced alignment matrix.

    ``tokens`` (B, S) teacher-forced sequences, ``cross_kv`` the float
    2-tuple (L, B, H, Ta, dh) (Shards under a mesh), ``head_mask`` (L, H)
    1.0 at an alignment head, ``row_mask`` (B, S) bool at the text rows (the
    prompt and the padding out), ``frame_len`` (B,) the valid audio frames.
    Per layer and head: standardization over the masked text rows of each
    frame, a median filter of ``medfilt_width`` (odd) along time with the
    reflect boundary at each row's ``frame_len``, then the head-masked sum;
    the matrix is that sum over layers divided by the mask's count. Returns
    (matrix (B, S, Ta) fp32, token_logprobs (B, S-1) fp32). Rows outside
    ``row_mask`` are divided by a near-zero deviation: read only the text
    rows and the frames below ``frame_len``.
    """
    if medfilt_width < 1 or medfilt_width % 2 == 0:
        raise ValueError(f"medfilt_width must be odd >= 1, got {medfilt_width}")
    if isinstance(model, DataParallelWhisper):
        outs = [alignment_matrix(m, t, c, head_mask, r, f, compute_dtype, medfilt_width, gelu)
                for m, t, c, r, f in zip(model.rows, _row_blocks(model, tokens),
                                         _row_values(model, cross_kv, "cross_kv"),
                                         _row_blocks(model, row_mask),
                                         _row_blocks(model, frame_len))]
        return _gather(model, [a for a, _ in outs]), _gather(model, [t for _, t in outs])
    shards = model_shards(model)
    n_head = model.cfg.n_text_head // len(shards)
    lead = tokens.device
    B, S = tokens.shape
    Ta = shard_values(cross_kv)[0][0].shape[3]
    hmask = head_mask.to(device=lead, dtype=torch.float32)
    per_rank = {}

    def local(device):
        """(rows, n_rows, taps) on ``device``, made once for each."""
        if device not in per_rank:
            rows = _to(row_mask, device)[:, None, :, None]                 # (B, 1, S, 1)
            n_rows = torch.clamp(rows.sum(dim=2, keepdim=True).to(torch.float32), min=1.0)
            taps = _reflect_taps(_to(frame_len, device), Ta, medfilt_width)[:, None, None]
            per_rank[device] = rows, n_rows, taps.expand(B, n_head, S, Ta, medfilt_width)
        return per_rank[device]

    acc = torch.zeros((B, S, Ta), dtype=torch.float32, device=lead)

    def reduce(layer, rank, w):
        nonlocal acc
        rows, n_rows, taps = local(w.device)
        mean = torch.where(rows, w, 0.0).sum(dim=2, keepdim=True) / n_rows
        var = torch.where(rows, (w - mean) ** 2, 0.0).sum(dim=2, keepdim=True) / n_rows
        z = (w - mean) / (torch.sqrt(var) + 1e-9)
        filt = _median_taps([torch.gather(z, 3, taps[..., i]) for i in range(medfilt_width)])
        hm = _to(hmask[layer, rank * n_head:(rank + 1) * n_head], w.device)
        acc = acc + _to(torch.einsum("bhst,h->bst", filt, hm), lead)

    tlp = _teacher_forced(model, tokens, cross_kv, compute_dtype, gelu, reduce)
    return acc / torch.clamp(hmask.sum(), min=1.0), tlp


def dequantize_cross_kv(cross_kv):
    """int8 4-tuple (``quantize_cross_kv`` layout) -> float 2-tuple
    (L, B, H, Ta, dh) fp32; a float 2-tuple as it is; :class:`Shards` rank
    by rank and :class:`DataRows` row by row."""
    if isinstance(cross_kv, (Shards, DataRows)):
        return type(cross_kv)(dequantize_cross_kv(c) for c in cross_kv)
    if len(cross_kv) == 2:
        return cross_kv
    k_q, k_s, v_q, v_s = cross_kv  # q: (L, B, H, dh, Ta); s: (L, B, H, 1, dh)
    k = k_q.transpose(-1, -2).to(torch.float32) * k_s
    v = v_q.transpose(-1, -2).to(torch.float32) * v_s
    return k, v


# ----------------------------------------------------------------- host side
def alignment_head_mask(cfg: WhisperConfig, sidecar: Optional[str] = None) -> np.ndarray:
    """(n_text_layer, n_text_head) bool mask of the heads used for alignment.

    Sidecar JSON format: ``{"<model-name>": [[layer, head], ...], ...}`` or a
    bare ``[[layer, head], ...]`` list, from ``sidecar`` or the
    ``WHISPER_TPU_ALIGNMENT_HEADS`` variable. Default (no sidecar entry):
    all heads of the last half of the layers, OpenAI's fallback for models
    without a stored mask.
    """
    mask = np.zeros((cfg.n_text_layer, cfg.n_text_head), bool)
    sidecar = sidecar or os.environ.get("WHISPER_TPU_ALIGNMENT_HEADS")
    if sidecar and os.path.exists(sidecar):
        with open(sidecar) as f:
            data = json.load(f)
        pairs = data.get(cfg.name) if isinstance(data, dict) else data
        if pairs:
            for layer, head in pairs:
                mask[int(layer), int(head)] = True
            return mask
    mask[cfg.n_text_layer // 2:] = True
    return mask


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis, reflect-padded (whisper timing)."""
    if width <= 1 or x.shape[-1] <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotone alignment path through ``cost`` (N_text, M_time).

    Classic DTW with (diagonal, up, left) moves, ties in that order; returns
    (text_idx, time_idx) tracing the minimum-cost path from (0, 0) to
    (N-1, M-1).
    """
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf, np.float64)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), np.int8)
    for i in range(1, N + 1):
        row = cost[i - 1]
        Dp = D[i - 1]
        Di = D[i]
        tr = trace[i]
        left = np.inf
        for j in range(1, M + 1):
            c0, c1, c2 = Dp[j - 1], Dp[j], left
            if c0 <= c1 and c0 <= c2:
                best, t = c0, 0  # diagonal: advance both
            elif c1 <= c2:
                best, t = c1, 1  # up: advance text
            else:
                best, t = c2, 2  # left: advance time
            left = row[j - 1] + best
            Di[j] = left
            tr[j] = t
    i, j = N, M
    ti: List[int] = []
    tj: List[int] = []
    while i > 0 and j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(tj[::-1])


def _word_boundaries(words: List[str], word_tokens: List[List[int]], text_idx: np.ndarray,
                     time_idx: np.ndarray, n_rows: int) -> List[Tuple[int, int]]:
    """Each word's (start_frame, end_frame) from the DTW path's jump times:
    the first frame aligned to its first row and to the row after it."""
    jump = np.zeros(n_rows + 1, int)
    seen = np.zeros(n_rows + 1, bool)
    for r, t in zip(text_idx, time_idx):
        if not seen[r]:
            jump[r] = t
            seen[r] = True
    jump[n_rows] = time_idx[-1] + 1 if len(time_idx) else 0
    # rows the path never visits take the next visited row's time
    for r in range(n_rows - 1, -1, -1):
        if not seen[r]:
            jump[r] = jump[r + 1]
    out = []
    row = 0
    for toks in word_tokens:
        start = jump[min(row, n_rows)]
        row += len(toks)
        end = jump[min(row, n_rows)]
        out.append((start, end))
    return out


def words_from_attention(
    attn: np.ndarray,                 # (L, H, S, Ta) fp32: ONE utterance's maps
    tokens: Sequence[int],            # the full sequence: prompt + text + eot
    prompt_len: int,
    tokenizer,
    cfg: WhisperConfig,
    num_frames: int,                  # frames the audio covers (<= Ta)
    token_logprobs: Optional[np.ndarray] = None,  # (S-1,)
    head_mask: Optional[np.ndarray] = None,
    medfilt_width: int = 7,
    time_offset: float = 0.0,
) -> List[dict]:
    """find_alignment on the host from the full maps of
    :func:`alignment_cross_attn`: the alignment heads' maps standardized per
    frame over the text rows, median-filtered, head-averaged, then
    :func:`words_from_matrix`."""
    if head_mask is None:
        head_mask = alignment_head_mask(cfg)
    text_tokens = [int(t) for t in tokens[prompt_len:]]
    sel = attn[head_mask][:, prompt_len:, :num_frames]  # (Nh, St, F)
    if sel.shape[1] == 0 or sel.shape[2] == 0:
        return []
    mean = sel.mean(axis=-2, keepdims=True)
    std = sel.std(axis=-2, keepdims=True) + 1e-9
    sel = median_filter((sel - mean) / std, medfilt_width)
    return words_from_matrix(sel.mean(axis=0), text_tokens, tokenizer,
                             token_logprobs=token_logprobs, prompt_len=prompt_len,
                             time_offset=time_offset)


def words_from_matrix(
    matrix: np.ndarray,               # (St, F) the reduced alignment matrix
    text_tokens: Sequence[int],       # the text rows, the trailing eot included
    tokenizer,
    token_logprobs: Optional[np.ndarray] = None,  # (S-1,) of the full sequence
    prompt_len: int = 0,              # only indexes token_logprobs
    time_offset: float = 0.0,
) -> List[dict]:
    """DTW and word grouping over the cropped rows and frames of an
    alignment matrix -> ``[{word, start, end, probability}]``.

    The trailing eot row is left out of the DTW (OpenAI's find_alignment
    crops ``matrix[len(sot_sequence):-1]``): its diffuse attention would
    drag the last word's end late. The path's end still bounds the last
    word."""
    text_tokens = [int(t) for t in text_tokens]
    if matrix.shape[0] == 0 or matrix.shape[1] == 0:
        return []
    n_dtw = max(matrix.shape[0] - 1, 1)  # drop the eot row
    text_idx, time_idx = dtw_path(-matrix[:n_dtw].astype(np.float64))

    words, word_tokens = tokenizer.split_to_word_tokens(text_tokens)
    bounds = _word_boundaries(words, word_tokens, text_idx, time_idx, n_rows=n_dtw)
    out = []
    row = 0
    for word, toks, (f0, f1) in zip(words, word_tokens, bounds):
        n = len(toks)
        prob = None
        if token_logprobs is not None:
            # the logprob of token i sits at i - 1 of the shifted array
            lo = prompt_len + row - 1
            lp = token_logprobs[max(lo, 0): lo + n]
            if len(lp):
                prob = float(np.exp(lp.mean()))
        row += n
        if all(t >= tokenizer.eot for t in toks):
            continue  # special-token-only "words" (eot, timestamps)
        rec = {
            "word": word,
            "start": round(time_offset + f0 * TIME_PER_FRAME, 3),
            "end": round(time_offset + max(f1, f0) * TIME_PER_FRAME, 3),
        }
        if prob is not None:
            rec["probability"] = round(prob, 4)
        out.append(rec)
    return out


def merge_punctuations(words: List[dict], prepended: str = "\"'“¿([{-",
                       appended: str = "\"'.。,，!！?？:：”)]}、") -> List[dict]:
    """Glue leading and trailing punctuation onto the neighbouring words
    (whisper semantics)."""
    out: List[dict] = []
    for w in words:
        s = w["word"].strip()
        if out and s and all(c in appended for c in s):
            out[-1] = dict(out[-1], word=out[-1]["word"] + w["word"].strip(), end=w["end"])
        else:
            out.append(dict(w))
    merged: List[dict] = []
    for w in reversed(out):
        s = w["word"].strip()
        if merged and s and all(c in prepended for c in s):
            nxt = merged[-1]
            merged[-1] = dict(nxt, word=w["word"].rstrip() + nxt["word"], start=w["start"])
        else:
            merged.append(w)
    return merged[::-1]


def tokenizer_for(tokenizer, language: str):
    """``tokenizer`` with ``language`` set (the JAX package's
    ``dataclasses.replace(tokenizer, language=...)``), sharing its decoding
    tables; a tokenizer without a ``language`` field as it is."""
    if getattr(tokenizer, "language", language) == language:
        return tokenizer
    tok = copy.copy(tokenizer)
    tok.language = language
    tok.__dict__.pop("sot_sequence", None)  # a cached property of the old language
    return tok


def row_words(matrix: np.ndarray, token_logprobs: np.ndarray, seq: np.ndarray,
              prompt_len: int, length: int, frames: int, language: str, tokenizer
              ) -> List[dict]:
    """The words of one row of a reduced batch (``matrix`` (S, Ta), its
    (S-1,) ``token_logprobs`` and teacher-forced ``seq`` (S,)):
    :func:`words_from_matrix` on the text rows [prompt_len, length) and the
    first ``frames`` frames, with the row's ``language`` for the word split,
    then :func:`merge_punctuations` outside the unspaced scripts."""
    ws = words_from_matrix(matrix[prompt_len:length, :frames], seq[prompt_len:length],
                           tokenizer_for(tokenizer, language), token_logprobs=token_logprobs,
                           prompt_len=prompt_len)
    return ws if language in UNSPACED else merge_punctuations(ws)
