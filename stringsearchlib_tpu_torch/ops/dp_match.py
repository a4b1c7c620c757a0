"""Batched semi-global edit distance (kernel K5) on Hopper.

``dp_match(tokens (N, W), lengths (N,), qtokens (B, Qp), qlens (B,))`` ->
(B, N) int32 match counts = qlen - the least edit distance between the
query and any substring of the term (free leading and trailing gaps in the
term; the final minimum runs over positions p <= len), the reference's
``stringMatch`` (nGramSearch.hpp:182-222).  Tokens are uint8 (narrow
indexes) or int32 (wide indexes hold code points); every qlen in [0, Qp]
and every width W is exact.

On a CUDA tensor the wrapper launches ``csrc/dp_match.cu``, the
counterpart of the TPU kernel ``tools/experimental/dp_pallas.py``
(``_dp_call``): Myers' bit-vector recurrence, one thread per term advancing
a chunk of queries by each term character, the state in ceil(Qp / 32)
32-bit words per query (registers up to 8 words, a global scratch past
that) and the match masks built in shared memory within the launch;
``plan`` says which instance and chunk it takes.  On a CPU tensor it runs
the plain version ``dp_match_ref``.  Nothing else chooses between the two:
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .kernels import count_launches, lib as _lib

# launches of the CUDA kernel, and calls of its plain version made by the
# wrapper for CPU tensors; plain integers that callers may reset
K5_LAUNCHES = 0
K5_REF_CALLS = 0

_BIG = 1 << 30
# mask words per table row: a chunk's queries x words per query
_LANES = 16
# words per query the register kernel is compiled for
_WORDS = (1, 2, 4, 8)
# bytes of the global scratch that holds the vectors of queries over 8 words
_STATE_BYTES = 64 << 20
_THREADS = 128


def dp_match_ref(tokens, lengths, qtokens, qlen):
    """Plain PyTorch version of ``dp_match``: one step per query character
    updates every term's DP row for every query at once; the in-row
    dependency is a min-plus prefix scan,

        row2[p] = min(row2[p-1] + 1, a[p]),   a[p] = min(row1[p]+1, row1[p-1]+cost)
      =>  row2[p] = p + cummin_k<=p (a[k] - k),  with a[0] := q+1

    Holds (B, N, W + 1) int32 per step."""
    n, width = tokens.shape
    b, qp = qtokens.shape
    dev = tokens.device
    positions = torch.arange(width + 1, dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32)[None]  # (1, N, L)
    row1 = torch.zeros((b, n, width + 1), dtype=torch.int32, device=dev)
    for q in range(qp):
        qc = qtokens[:, q].to(torch.int32)[:, None, None]
        active = (qlen > q)[:, None, None]
        cost = (tok != qc).to(torch.int32)  # (B, N, L)
        a = torch.minimum(row1[:, :, 1:] + 1, row1[:, :, :-1] + cost)
        d0 = torch.full((b, n, 1), q + 1, dtype=torch.int32, device=dev)
        d = torch.cat([d0, a - positions[1:]], dim=2)
        row2 = positions + torch.cummin(d, dim=2).values
        row1 = torch.where(active, row2, row1)
    # min over p in [0, len] only (nGramSearch.hpp:217-220)
    in_range = positions[None, :] <= lengths[:, None]  # (N, L+1)
    mismatch = torch.where(in_range, row1, _BIG).amin(dim=2)
    return qlen.to(torch.int32)[:, None] - mismatch


def plan(qp: int, n: int = 0, b: int = _LANES) -> dict:
    """How ``dp_match`` launches K5 for ``b`` queries padded to ``qp`` over
    ``n`` terms: ``words`` = ceil(qp / 32) (at least 1); ``nw``, the
    register instance (the least of 1, 2, 4, 8 that holds ``words``, else 0
    for the scratch kernel); ``qc``, the queries of a block's chunk: 16 / nw,
    or 1 when ``b`` fills at most an eighth of such a chunk, or is 1 (a
    thread's registers then hold one query's state, so three times as many
    blocks fit an SM, which outweighs reading the terms once per query;
    1 in the scratch kernel); ``threads``, the scratch kernel's grid of
    threads (0 otherwise)."""
    words = max(1, -(-qp // 32))
    nw = next((s for s in _WORDS if words <= s), 0)
    if nw == 0:
        fit = max(_STATE_BYTES // (8 * words * _THREADS), 1) * _THREADS
        threads = min(fit, -(-max(n, 1) // _THREADS) * _THREADS)
        return {"nw": 0, "qc": 1, "words": words, "threads": threads}
    full = _LANES // nw
    qc = 1 if b <= max(1, full // 8) else full
    return {"nw": nw, "qc": qc, "words": words, "threads": 0}


def dp_match(tokens, lengths, qtokens, qlen):
    """(B, N) int32 match counts: qlen - semi-global edit distance.

    CUDA tensors launch the K5 kernel; CPU tensors run the plain version."""
    global K5_REF_CALLS
    if tokens.ndim != 2 or qtokens.ndim != 2:
        raise ValueError(f"tokens {tuple(tokens.shape)} and qtokens "
                         f"{tuple(qtokens.shape)} must be 2-D")
    n, w = tokens.shape
    b, qp = qtokens.shape
    if lengths.shape != (n,) or qlen.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} / qlens "
                         f"{tuple(qlen.shape)} do not match ({n},) / ({b},)")
    devs = {t.device for t in (tokens, lengths, qtokens, qlen)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if tokens.device.type == "cpu":
        K5_REF_CALLS += 1
        return dp_match_ref(tokens, lengths, qtokens, qlen)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    if tokens.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"tokens must be uint8 or int32, got {tokens.dtype}")
    for name, t in (("lengths", lengths), ("qtokens", qtokens), ("qlens", qlen)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not tokens.is_contiguous():
        raise ValueError("tokens must be contiguous")
    out = torch.empty((b, n), dtype=torch.int32, device=tokens.device)
    if n == 0 or b == 0:
        return out
    p = plan(qp, n, b)
    scratch = out
    if p["nw"] == 0:
        scratch = torch.empty(2 * p["words"] * p["threads"], dtype=torch.int32,
                              device=tokens.device)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        err = _lib("dp_match").dp_match_launch(
            tokens.data_ptr(), lengths.data_ptr(), qtokens.data_ptr(),
            qlen.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, w, b, qp,
            tokens.element_size(), p["nw"], p["qc"], p["threads"], stream,
        )
    if err != 0:
        raise RuntimeError(f"dp_match kernel launch failed: cuda error {err}")
    count_launches(globals(), "K5_LAUNCHES")
    return out
