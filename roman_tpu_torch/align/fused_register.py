"""The fused ROMAN registration path: CUDA kernels and their plain twins.

Port of roman_tpu/align/fused_register.py. The TPU kernel ``_kernel``
(K1, fused_register.py:111) built the (N, N) affinity, solved, rounded
and refined in one VMEM-resident program. On Hopper one pair's bf16
affinity (5.12 MB at N = 1600) does not fit an SM's shared memory, so the
path is split by what the card holds, four launches per batch of pairs:

1. ``assoc_terms``    per-association ratio and cosine scores as
                      half-logs, nonzero flags, single scores, valid flags
                      (flat N-vectors);
2. ``build_affinity`` M (P, N, N) bf16 into HBM, entry by entry;
3. ``clipper_solve``  the CLIPPER solve (``align.clipper_solve``, shared
                      with the arithmetic-mean and product fusions);
4. ``round_refine``   greedy one-to-one rounding and support refinement.

Each stage's wrapper launches its kernel (``csrc/fused_register.cu``) for
CUDA tensors and runs its plain PyTorch twin only for CPU tensors.
``fused_register`` chains the wrappers; ``fused_register_plain`` chains
the twins on any device, which is what the kernels are held against on
the card.

The twins mirror the TPU kernel's own formulation, not
``invariants.affinity``: per-association scores enter as half-logs added
in row-then-column order, distances use sqrt(x + 1e-20), and M is rounded
to bf16 (fused_register.py:175-176, :267-300). Every matvec is u @ M,
out[j] = sum_i u_i M[i, j] (fused_register.py:354): the log-space adds
make M not bitwise symmetric, so kernel and twin use one orientation.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from roman_tpu_torch import tracing
from roman_tpu_torch.align import clipper
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.clipper_solve import (check_solve_shape, clipper_solve,
                                                 clipper_solve_plain)
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# pairs per slab of the plain affinity build: bounds its (slab, N, N) f32
# intermediates (about 160 MB each at N = 1600)
_PLAIN_SLAB = 16
# n, m and max_steps that round_refine takes at most (kRoundMaxSide of
# csrc/fused_register.cu: a thread and a bitmask bit a selected entry)
ROUND_MAX_SIDE = 256


@dataclasses.dataclass(frozen=True)
class FusedInvariantStatics:
    """Invariant, rounding and refinement configuration of the fused path
    (roman_tpu/align/fused_register.py:58-78)."""

    sigma: float = 0.4
    epsilon: float = 0.6
    mindist: float = 0.2
    cos_min: float = 0.85
    cos_max: float = 1.0
    eps_shape: float = 0.0
    gravity: bool = True
    gravity_unc_ang_rad: float = 0.0872665
    use_ratio: bool = True
    use_cosine: bool = True
    # rounding / refinement (clipper.round_greedy / refine_selection_2d)
    rel_thresh: float = 0.35
    refine_iters: int = 6
    min_support: float = 0.22
    rel_support: float = 0.5
    edge_eps: float = 1e-4
    max_clique: int = 64

    @property
    def n_terms(self) -> int:
        return int(self.use_ratio) + int(self.use_cosine)

    @property
    def cos_den(self) -> float:
        return max(self.cos_max - self.cos_min, 1e-9)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an elementwise IEEE division (PyTorch turns division by a
    Python scalar into a multiplication by its reciprocal on CUDA; the
    kernels divide)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# 1. per-association terms
# ---------------------------------------------------------------------------

def assoc_terms_plain(r1, d1, r2, d2, valid, inv: FusedInvariantStatics):
    """Plain twin of the assoc_terms kernel.

    r1 (P, n, F), d1 (P, n, D), r2 (P, m, F), d2 (P, m, D), valid (P, n, m),
    all f32. Returns hl (P, 2, N) half-log scores and nz (P, 2, N) 0/1
    flags (score > 1e-20) of the ratio then cosine term (unused slots are
    zero), single (P, N) fused single scores, vflat (P, N) 0/1 valid.
    """
    P, n = r1.shape[:2]
    m = r2.shape[1]
    N = n * m
    dev = r1.device
    scores = []
    if inv.use_ratio:
        logsum = torch.zeros((P, n, m), dtype=torch.float32, device=dev)
        all_nz = torch.ones((P, n, m), dtype=torch.bool, device=dev)
        F = r1.shape[-1]
        for f in range(F):
            x = torch.abs(r1[:, :, None, f])
            y = torch.abs(r2[:, None, :, f])
            rho = torch.minimum(x, y) / torch.clamp(torch.maximum(x, y), min=1e-9)
            rho = torch.where(rho >= inv.eps_shape, rho, 0.0)
            logsum = logsum + torch.log(torch.clamp(rho, min=1e-20))
            all_nz = all_nz & (rho > 0)
        scores.append(torch.exp(_div(logsum, F)) * all_nz)
    if inv.use_cosine:
        na = torch.sqrt(torch.sum(d1 * d1, dim=-1))
        nb = torch.sqrt(torch.sum(d2 * d2, dim=-1))
        dot = torch.bmm(d1, d2.transpose(1, 2))
        den = na[:, :, None] * nb[:, None, :]
        cos = torch.where(den > 1e-9, dot / torch.clamp(den, min=1e-9), 1.0)
        missing = (na[:, :, None] < 1e-9) | (nb[:, None, :] < 1e-9)
        s = torch.clamp(_div(cos - inv.cos_min, inv.cos_den), 0.0, 1.0)
        scores.append(torch.where(missing, 1.0, s))
    hl = torch.zeros((P, 2, N), dtype=torch.float32, device=dev)
    nz = torch.zeros((P, 2, N), dtype=torch.float32, device=dev)
    log_single = torch.zeros((P, n, m), dtype=torch.float32, device=dev)
    single_nz = torch.ones((P, n, m), dtype=torch.bool, device=dev)
    for t, s in enumerate(scores):
        lg = torch.log(torch.clamp(s, min=1e-20))
        hl[:, t] = (0.5 * lg).reshape(P, N)
        nz[:, t] = (s > 1e-20).float().reshape(P, N)
        log_single = log_single + lg
        single_nz = single_nz & (s > 0)
    if scores:
        single = torch.exp(_div(log_single, len(scores))) * single_nz
    else:
        single = torch.ones((P, n, m), dtype=torch.float32, device=dev)
    vb = valid > 0.5
    single = torch.where(vb, single, 0.0)
    return hl, nz, single.reshape(P, N), vb.float().reshape(P, N)


def assoc_terms(r1, d1, r2, d2, valid, inv: FusedInvariantStatics):
    """Per-association terms of every pair: the kernel for CUDA tensors,
    the plain twin for CPU tensors (see assoc_terms_plain)."""
    if r1.device.type == "cpu":
        return assoc_terms_plain(r1, d1, r2, d2, valid, inv)
    P, n, F = r1.shape
    m, D = r2.shape[1], d1.shape[-1]
    dev = r1.device
    build.check_tensor("r1", r1, (P, n, F), torch.float32, dev)
    build.check_tensor("r2", r2, (P, m, F), torch.float32, dev)
    build.check_tensor("d1", d1, (P, n, D), torch.float32, dev)
    build.check_tensor("d2", d2, (P, m, D), torch.float32, dev)
    build.check_tensor("valid", valid, (P, n, m), torch.float32, dev)
    N = n * m
    hl = torch.zeros((P, 2, N), dtype=torch.float32, device=dev)
    nz = torch.zeros((P, 2, N), dtype=torch.float32, device=dev)
    single = torch.empty((P, N), dtype=torch.float32, device=dev)
    vflat = torch.empty((P, N), dtype=torch.float32, device=dev)
    if P == 0:
        return hl, nz, single, vflat
    fn = build.function("fused_register", "assoc_terms_launch",
                        [_P] * 9 + [_I] * 7 + [_F] * 3 + [_P])
    with torch.cuda.device(dev):
        err = fn(r1.data_ptr(), d1.data_ptr(), r2.data_ptr(), d2.data_ptr(),
                 valid.data_ptr(), hl.data_ptr(), nz.data_ptr(),
                 single.data_ptr(), vflat.data_ptr(), P, n, m, F, D,
                 int(inv.use_ratio), int(inv.use_cosine), inv.eps_shape,
                 inv.cos_min, inv.cos_den,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("assoc_terms", err)
    assoc_terms.launches += 1
    return hl, nz, single, vflat


assoc_terms.launches = 0


# ---------------------------------------------------------------------------
# 2. the (N, N) affinity
# ---------------------------------------------------------------------------

def _affinity_slab(c1, c2, hl, nz, single, vflat, inv: FusedInvariantStatics):
    n, m = c1.shape[1], c2.shape[1]
    N = n * m
    dev = c1.device
    idx = torch.arange(N, device=dev)
    a, b = idx // m, idx % m

    def geometry(p):  # p (S, N, 3) endpoint coordinates; row i minus column j
        dX = p[:, :, None, 0] - p[:, None, :, 0]
        dY = p[:, :, None, 1] - p[:, None, :, 1]
        dZ = p[:, :, None, 2] - p[:, None, :, 2]
        dxy2 = dX * dX + dY * dY
        return (torch.sqrt(dxy2 + dZ * dZ + 1e-20), torch.abs(dZ),
                torch.sqrt(dxy2 + 1e-20))

    D1, dz1, dxy1 = geometry(c1[:, a])
    D2, dz2, dxy2 = geometry(c2[:, b])
    gate = (D1 > inv.mindist) & (D2 > inv.mindist)
    if inv.gravity:
        slack = math.sin(inv.gravity_unc_ang_rad) * torch.maximum(D1, D2)
        cz = torch.clamp(torch.abs(dz1 - dz2) - slack, min=0.0)
        cxy = torch.abs(dxy1 - dxy2)
        cdist = torch.sqrt(cz * cz + cxy * cxy + 1e-20)
    else:
        cdist = torch.abs(D1 - D2)
    tq = _div(cdist, inv.sigma)
    sd = torch.exp(-0.5 * (tq * tq))
    sd = torch.where((cdist < inv.epsilon) & gate, sd, 0.0)
    logM = torch.log(torch.clamp(sd, min=1e-20))
    nonzero = sd > 0.0
    for t in range(inv.n_terms):
        logM = logM + hl[:, t, :, None]
        logM = logM + hl[:, t, None, :]
        nonzero = nonzero & (nz[:, t, :, None] > 0.5) & (nz[:, t, None, :] > 0.5)
    M = torch.exp(_div(logM, 1 + inv.n_terms)) * nonzero
    same_a = a[:, None] == a[None, :]
    same_b = b[:, None] == b[None, :]
    diag = same_a & same_b
    valid4 = (vflat[:, :, None] > 0.5) & (vflat[:, None, :] > 0.5)
    M = torch.where((same_a != same_b) | diag | ~valid4, 0.0, M)
    M = M + torch.where(diag & valid4, single[:, None, :] + 0.0 * M, 0.0)
    return M.to(torch.bfloat16)


def build_affinity_plain(c1, c2, hl, nz, single, vflat,
                         inv: FusedInvariantStatics):
    """Plain twin of the build_affinity kernel.

    c1 (P, n, 3), c2 (P, m, 3) f32 centers and the assoc_terms outputs.
    Returns M (P, N, N) bf16 with M[i, j] for association i (row) and
    j (column). Built in slabs of pairs to bound the f32 intermediates.
    """
    P = c1.shape[0]
    N = c1.shape[1] * c2.shape[1]
    M = torch.empty((P, N, N), dtype=torch.bfloat16, device=c1.device)
    for s in range(0, P, _PLAIN_SLAB):
        e = min(s + _PLAIN_SLAB, P)
        M[s:e] = _affinity_slab(c1[s:e], c2[s:e], hl[s:e], nz[s:e],
                                single[s:e], vflat[s:e], inv)
    return M


def offdiag_nonzeros(M: torch.Tensor) -> torch.Tensor:
    """(P,) int64: each pair's nonzero entries of M (P, N, N) off its
    diagonal."""
    P = M.shape[0]
    return (torch.count_nonzero(M.reshape(P, -1), dim=-1)
            - torch.count_nonzero(torch.diagonal(M, dim1=1, dim2=2), dim=-1))


def build_affinity(c1, c2, hl, nz, single, vflat, inv: FusedInvariantStatics):
    """The (P, N, N) bf16 affinity of every pair: the kernel for CUDA
    tensors, the plain twin for CPU tensors (see build_affinity_plain).
    While tracing records, it adds P to counter "affinity.pairs" and each
    pair's nonzero entries off the diagonal to "affinity.nonzeros" (on the
    card the kernel counts them, and the sum waits until it is read)."""
    if c1.device.type == "cpu":
        M = build_affinity_plain(c1, c2, hl, nz, single, vflat, inv)
        if tracing.recording():
            tracing.count("affinity.pairs", M.shape[0])
            tracing.count_device("affinity.nonzeros", offdiag_nonzeros(M))
        return M
    P, n = c1.shape[:2]
    m = c2.shape[1]
    N = n * m
    dev = c1.device
    build.check_tensor("c1", c1, (P, n, 3), torch.float32, dev)
    build.check_tensor("c2", c2, (P, m, 3), torch.float32, dev)
    build.check_tensor("hl", hl, (P, 2, N), torch.float32, dev)
    build.check_tensor("nz", nz, (P, 2, N), torch.float32, dev)
    build.check_tensor("single", single, (P, N), torch.float32, dev)
    build.check_tensor("vflat", vflat, (P, N), torch.float32, dev)
    M = torch.empty((P, N, N), dtype=torch.bfloat16, device=dev)
    if P == 0:
        return M
    # each pair's nonzeros off the diagonal, only while tracing (the launch
    # sets them to 0 first: a memset, no kernel)
    counts = (torch.empty(P, dtype=torch.int32, device=dev)
              if tracing.recording() else None)
    fn = build.function("fused_register", "build_affinity_launch",
                        [_P] * 8 + [_I] * 5 + [_F] * 4 + [_P])
    with torch.cuda.device(dev):
        err = fn(c1.data_ptr(), c2.data_ptr(), hl.data_ptr(), nz.data_ptr(),
                 single.data_ptr(), vflat.data_ptr(), M.data_ptr(),
                 None if counts is None else counts.data_ptr(), P, n, m,
                 inv.n_terms, int(inv.gravity), inv.sigma, inv.epsilon,
                 inv.mindist, math.sin(inv.gravity_unc_ang_rad),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("build_affinity", err)
    build_affinity.launches += 1
    if counts is not None:
        tracing.count("affinity.pairs", P)
        tracing.count_device("affinity.nonzeros", counts)
    return M


build_affinity.launches = 0


# ---------------------------------------------------------------------------
# 4. rounding and refinement
# ---------------------------------------------------------------------------

def round_refine_plain(M, u, F, omega, n: int, m: int,
                       inv: FusedInvariantStatics):
    """Plain twin of the round_refine kernel: clipper.round_greedy with
    the penalized F as rounding cap, then clipper.refine_selection_2d with
    the unpenalized omega as target. M (P, N, N) bf16, u (P, N), F and
    omega (P,). Returns sel (P, N) bool and count (P,) int32."""
    P = M.shape[0]
    max_steps = min(inv.max_clique, n, m)
    sel, _ = clipper.round_greedy(u.reshape(P, n, m), F, max_steps,
                                  inv.rel_thresh)
    sel, count = clipper.refine_selection_2d(
        M, sel, inv.refine_iters, inv.min_support, inv.rel_support,
        inv.edge_eps, target=omega)
    return sel.reshape(P, n * m), count


def check_round_shape(n: int, m: int) -> None:
    """Raise ValueError unless round_refine takes n x m (each side up to
    ROUND_MAX_SIDE)."""
    if n > ROUND_MAX_SIDE or m > ROUND_MAX_SIDE:
        raise ValueError(f"round_refine takes n and m up to {ROUND_MAX_SIDE}, "
                         f"got {n} x {m}")


def round_refine(M, u, F, omega, n: int, m: int, inv: FusedInvariantStatics):
    """Rounding and refinement of every pair: the kernel for CUDA tensors,
    the plain twin for CPU tensors (see round_refine_plain)."""
    if M.device.type == "cpu":
        return round_refine_plain(M, u, F, omega, n, m, inv)
    P, N = M.shape[0], n * m
    dev = M.device
    check_round_shape(n, m)
    build.check_tensor("M", M, (P, N, N), torch.bfloat16, dev)
    build.check_tensor("u", u, (P, N), torch.float32, dev)
    build.check_tensor("F", F, (P,), torch.float32, dev)
    build.check_tensor("omega", omega, (P,), torch.float32, dev)
    max_steps = min(inv.max_clique, n, m)
    sel = torch.empty((P, N), dtype=torch.bool, device=dev)
    count = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return sel, count
    fn = build.function("fused_register", "round_refine_launch",
                        [_P] * 6 + [_I] * 5 + [_F] * 4 + [_P])
    with torch.cuda.device(dev):
        err = fn(M.data_ptr(), u.data_ptr(), F.data_ptr(), omega.data_ptr(),
                 sel.data_ptr(), count.data_ptr(), P, n, m, max_steps,
                 inv.refine_iters, inv.rel_thresh, inv.min_support,
                 inv.rel_support, inv.edge_eps,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("round_refine", err)
    round_refine.launches += 1
    return sel, count


round_refine.launches = 0

KERNELS = (assoc_terms, build_affinity, clipper_solve, round_refine)
PLAIN = (assoc_terms_plain, build_affinity_plain, clipper_solve_plain,
         round_refine_plain)


def check_shape(n: int, m: int, P: int, n_restarts: int, device) -> None:
    """Raise ValueError unless the kernels take P pairs of n x m at
    n_restarts restarts on this card: the limits of clipper_solve (its
    vectors in a block's shared memory) and round_refine (its sides). The
    other two kernels take more: build_affinity's tables need about
    (4 n_terms + 1.5) N bytes a block where the solve needs 12.5 N. The
    fused path calls it before its first launch, so a refused shape
    launches nothing."""
    check_solve_shape(n, m, n_restarts, P, device)
    check_round_shape(n, m)


def largest_side(n_restarts: int, device, P: int = 1) -> int:
    """The largest k such that the kernels take P pairs of k x k on this
    card (at most ROUND_MAX_SIDE), by bisection on check_shape."""
    def takes(k):
        try:
            check_shape(k, k, P, n_restarts, device)
        except ValueError:
            return False
        return True

    lo, hi = 1, ROUND_MAX_SIDE
    if takes(hi):
        return hi
    while hi - lo > 1:  # takes(lo) and not takes(hi)
        mid = (lo + hi) // 2
        if takes(mid):
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# the whole path
# ---------------------------------------------------------------------------

def _fused(f1: SubmapFeatures, f2: SubmapFeatures, inv: FusedInvariantStatics,
           params: ClipperSolveParams, assoc_mask, stages):
    n, m = f1.capacity, f2.capacity
    batch = f1.centers.shape[:-2]
    valid = f1.valid[..., :, None] & f2.valid[..., None, :]
    if assoc_mask is not None:
        valid = valid & assoc_mask
    Fdim = f1.ratio_feats.shape[-1]
    Ddim = f1.descriptors.shape[-1]
    inv = dataclasses.replace(inv, use_ratio=inv.use_ratio and Fdim > 0,
                              use_cosine=inv.use_cosine and Ddim > 0)
    P = math.prod(batch)
    if stages is KERNELS and f1.centers.device.type == "cuda":
        check_shape(n, m, P, params.n_restarts, f1.centers.device)

    def flat(x, tail):  # (P,) + tail, also where tail holds a 0 (D = 0)
        return x.reshape((P,) + tail).to(torch.float32).contiguous()

    c1, c2 = flat(f1.centers, (n, 3)), flat(f2.centers, (m, 3))
    r1, r2 = flat(f1.ratio_feats, (n, Fdim)), flat(f2.ratio_feats, (m, Fdim))
    d1, d2 = flat(f1.descriptors, (n, Ddim)), flat(f2.descriptors, (m, Ddim))
    terms, affinity, solve, rounding = stages
    hl, nz, single, vflat = terms(r1, d1, r2, d2, flat(valid, (n, m)), inv)
    M = affinity(c1, c2, hl, nz, single, vflat, inv)
    u, _, F, omega = solve(M, vflat, n, m, params)
    sel, count = rounding(M, u, F, omega, n, m, inv)
    return (sel.reshape(batch + (n, m)), count.reshape(batch),
            u.reshape(batch + (n, m)), F.reshape(batch))


def fused_register(f1: SubmapFeatures, f2: SubmapFeatures,
                   inv: FusedInvariantStatics,
                   params: ClipperSolveParams = ClipperSolveParams(),
                   assoc_mask=None):
    """Register batched SubmapFeatures pairs through the fused path.

    f1/f2: SubmapFeatures with matching leading batch dims. Launches the
    four kernels for CUDA tensors; runs the plain twins for CPU tensors.
    Returns (sel (..., n, m) bool, count (...) int32, u (..., n, m) f32,
    F (...) f32), the solve_and_round contract.
    """
    return _fused(f1, f2, inv, params, assoc_mask, KERNELS)


def fused_register_plain(f1: SubmapFeatures, f2: SubmapFeatures,
                         inv: FusedInvariantStatics,
                         params: ClipperSolveParams = ClipperSolveParams(),
                         assoc_mask=None):
    """fused_register through the plain twins, on any device: the
    reference the kernels are held against on the card."""
    return _fused(f1, f2, inv, params, assoc_mask, PLAIN)
