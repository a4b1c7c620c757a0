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
(``_dp_call``): one thread per (query, term) pair with Sellers' DP held in
registers along the shorter of the two static bounds (Qp or W, up to 64),
else in a global scratch column.  On a CPU tensor it runs the plain version
``dp_match_ref``.  Nothing else chooses between the two: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .kernels import lib as _lib

# launches of the CUDA kernel, and calls of its plain version made by the
# wrapper for CPU tensors; plain integers that callers may reset
K5_LAUNCHES = 0
K5_REF_CALLS = 0

_BIG = 1 << 30
# register state bounds the kernel is compiled for
_STATES = (8, 16, 32, 64)
# bytes of the scratch column buffer the widest form may hold
_SCRATCH_BYTES = 256 << 20
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


def _state_bound(n: int):
    for s in _STATES:
        if n <= s:
            return s
    return None


def pick_form(qp: int, w: int) -> str:
    """The kernel form ``dp_match`` launches for queries padded to ``qp``
    and terms of width ``w``: the state in registers along the shorter
    static bound, the query ("query") or the term ("term"), while one of
    them fits a register bound, else a global scratch column along the
    query ("scratch")."""
    s_q, s_w = _state_bound(qp), _state_bound(w)
    if s_q is not None and (s_w is None or qp <= w):
        return "query"
    return "term" if s_w is not None else "scratch"


def launch_form(tokens, lengths, qtokens, qlen, form: str):
    """One launch of the kernel in ``form`` ("query", "term" or "scratch")
    on operands ``dp_match`` has checked: (B, N) int32.  Counts nothing;
    ``dp_match`` is the wrapper that picks the form and counts its
    launches."""
    n, w = tokens.shape
    b, qp = qtokens.shape
    out = torch.empty((b, n), dtype=torch.int32, device=tokens.device)
    if n == 0 or b == 0:
        return out
    scratch, threads = out, 0
    if form == "scratch":
        s = 0
        fit = max(_SCRATCH_BYTES // (4 * (qp + 1)) // _THREADS, 1) * _THREADS
        threads = min(fit, -(-n // _THREADS) * _THREADS)
        scratch = torch.empty(threads * (qp + 1), dtype=torch.int32,
                              device=tokens.device)
    else:
        s = _state_bound(qp if form == "query" else w)
        if s is None:
            raise ValueError(f"no register bound holds the {form} form at "
                             f"Qp {qp}, W {w}")
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        err = _lib("dp_match").dp_match_launch(
            tokens.data_ptr(), lengths.data_ptr(), qtokens.data_ptr(),
            qlen.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, w, b, qp,
            tokens.element_size(), int(form != "term"), s, threads, stream,
        )
    if err != 0:
        raise RuntimeError(f"dp_match kernel launch failed: cuda error {err}")
    return out


def dp_match(tokens, lengths, qtokens, qlen):
    """(B, N) int32 match counts: qlen - semi-global edit distance.

    CUDA tensors launch the K5 kernel; CPU tensors run the plain version."""
    global K5_LAUNCHES, K5_REF_CALLS
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
    if n == 0 or b == 0:
        return torch.empty((b, n), dtype=torch.int32, device=tokens.device)
    out = launch_form(tokens, lengths, qtokens, qlen, pick_form(qp, w))
    K5_LAUNCHES += 1
    return out
