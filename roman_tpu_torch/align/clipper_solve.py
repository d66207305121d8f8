"""The CLIPPER solve on a prepared affinity: CUDA kernel and plain twin.

Replaces roman_tpu/align/clipper_pallas.py:50 ``_solve_kernel`` (K2), and
is also the solve phase of roman_tpu/align/fused_register.py:111
``_kernel`` (K1). On a prepared (P, N, N) bf16 M and a (P, N) f32 valid
mask it runs, per pair:

- warmup  u <- normalize((Mu + u) * valid)   from u0 = normalize(valid + 1e-3);
- R > 1:  restart r blends the warmed start toward ``restart_noise`` row r,
          u_r = normalize((u (1 - r/R) + max(u) (r/R) z_r) * valid); row 0
          keeps the warmed start;
- homotopy u <- normalize(max(Mu - d Cb u, 0) * valid), Cb u = rowsum +
          colsum - 2u, with d += sum_viol Mu / sum_viol Cb u (+1e-3 while
          violations remain);
- the restart with the best feasible omega = u'Mu wins (lowest index on a
  tie); returns u, d, F = u'(M - d Cb)u and omega.

Every matvec is u @ M, out[j] = sum_i u_i M[i, j], with u rounded to bf16
and products summed in f32, as both TPU kernels compute it. The fused
affinity is not bitwise symmetric, so the orientation matters.

The kernel is ``csrc/clipper_solve.cu``; the wrapper ``clipper_solve``
launches it for CUDA tensors and runs ``clipper_solve_plain`` only for CPU
tensors. The kernel solves each pair on a thread block cluster of
``cluster_size(P, SMs)`` blocks, each owning a slice of M's columns: it
streams the slice once, and keeps the slice's rows that hold a nonzero in
shared memory for the other matvecs where they fit; else, where the slice's
nonzeros are few enough, it writes them once into a compact form in the
launch's scratch and reads that (else it streams the slice every time).
While a profiler records (``tracing``), the launch also counts the pairs
(``solve.pairs``), their live rows of M (``solve.live_rows``), the pairs
whose blocks all kept their rows (``solve.resident_pairs``) and those that
read the compact form with no block streaming (``solve.compact_pairs``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from roman_tpu_torch import tracing
from roman_tpu_torch.align.clipper import ClipperSolveParams, restart_noise
from roman_tpu_torch.device import to_device
from roman_tpu_torch.kernels import build

_EPS = 1e-9
MAX_RESTARTS = 8  # kernel instantiations: R = 1..8 restart rows
MAX_CLUSTER = 8   # the largest portable thread block cluster


def cluster_size(P: int, sms: int) -> int:
    """Blocks per pair for a launch of P pairs on a card with `sms` SMs:
    the largest power of two C <= MAX_CLUSTER with P * C <= sms, and 1
    when P alone passes sms (the launch then runs in waves)."""
    C = MAX_CLUSTER
    while C > 1 and P * C > sms:
        C //= 2
    return C


def compact_words(N: int, C: int) -> int:
    """Words (int32) of one block's region of the kernel's scratch at
    cluster size C: csrc/clipper_solve.cu's compact_words, which the
    launcher checks. The form's bookkeeping (counts of up to max(Wp, 4096)
    lists, three words a column, the chunks' starts, a histogram of N + 1),
    then up to N * Wp / 8 words of the form: a quarter of the bytes of the
    block's slice of M, Wp columns wide."""
    Wp = (-(-N // C) + 7) // 8 * 8
    head = max(Wp, 8 * 512) + 3 * Wp + Wp // 32 + 2 + N + 1
    return (head + 31) // 32 * 32 + (N * Wp // 8 + 31) // 32 * 32


@functools.lru_cache(maxsize=None)
def device_noise(R: int, N: int, device: torch.device) -> torch.Tensor:
    """restart_noise(R, N) on `device`, one tensor for each (R, N, device):
    the first use uploads it (through to_device, one wait), every later
    launch reads the same tensor with no copy from host memory. Read only:
    the kernel and the twin never write it. An entry is R * N floats (6.4 KB
    at R = 1 and capacity 40), one for each pair shape a process solves."""
    return to_device(restart_noise(R, N), device)


def clipper_solve_plain(M: torch.Tensor, valid: torch.Tensor, n: int, m: int,
                        params: ClipperSolveParams = ClipperSolveParams()):
    """Plain PyTorch twin of the kernel on any device.

    M (P, N, N) bf16, valid (P, N) f32. Returns u (P, N), d (P,), F (P,),
    omega (P,), all f32.
    """
    P, N, _ = M.shape
    R = params.n_restarts
    dev = M.device
    Mf = M.float()
    v = valid.to(torch.float32)[:, None, :]  # (P, 1, N)

    def matvec(U):  # (P, r, N) -> (P, r, N): exact bf16 x bf16, f32 sums
        return torch.bmm(U.to(torch.bfloat16).float(), Mf)

    def cb_matvec(U):
        Um = U.reshape(P, -1, n, m)
        rs = torch.sum(Um, dim=-1, keepdim=True)
        cs = torch.sum(Um, dim=-2, keepdim=True)
        return (rs + cs).reshape(P, -1, N) - 2.0 * U

    def normalize(U):
        nrm = torch.sqrt(torch.sum(U * U, dim=-1, keepdim=True))
        return U / torch.clamp(nrm, min=_EPS)

    U = normalize(v + 1e-3)
    for _ in range(params.warmup_iters):
        U = normalize((matvec(U) + U) * v)
    if R > 1:
        noise = device_noise(R, N, dev)[None]
        a = (torch.arange(R, dtype=torch.float32, device=dev) / R)[None, :, None]
        umax = torch.amax(U, dim=-1, keepdim=True)
        pert = normalize((U * (1.0 - a) + umax * a * noise) * v)
        U = torch.where(a == 0.0, U, pert)
    d = torch.zeros((P, R, 1), dtype=torch.float32, device=dev)
    for _ in range(params.outer_iters):
        for _ in range(params.inner_iters):
            g = matvec(U) - d * cb_matvec(U)
            Un = torch.clamp(g, min=0.0) * v
            nrm = torch.sqrt(torch.sum(Un * Un, dim=-1, keepdim=True))
            U = torch.where(nrm > _EPS, Un / torch.clamp(nrm, min=_EPS), U)
        Mu = matvec(U)
        Cbu = cb_matvec(U)
        viol = (U > params.active_eps) & (Cbu > params.active_eps)
        num = torch.sum(torch.where(viol, Mu, 0.0), dim=-1, keepdim=True)
        den = torch.sum(torch.where(viol, Cbu, 0.0), dim=-1, keepdim=True)
        delta = torch.where(den > _EPS, num / torch.clamp(den, min=_EPS), 0.0)
        d = d + delta + torch.where(torch.any(viol, dim=-1, keepdim=True), 1e-3, 0.0)
    Mu = matvec(U)
    Cbu = cb_matvec(U)
    F = torch.sum(U * (Mu - d * Cbu), dim=-1)  # (P, R)
    omega = torch.sum(U * Mu, dim=-1)
    best = torch.zeros(P, dtype=torch.long, device=dev)
    if R > 1:
        anyviol = torch.any((U > params.active_eps) & (Cbu > params.active_eps), dim=-1)
        score = omega - torch.where(anyviol, 1e30, 0.0)
        best = torch.argmax(score, dim=-1)  # first maximum: restart 0 wins ties
    rows = torch.arange(P, device=dev)
    return U[rows, best], d[rows, best, 0], F[rows, best], omega[rows, best]


def solve_fits(N: int, n: int, m: int, R: int, C: int, device) -> tuple:
    """(need, avail, clusters) of the kernel's register-load path, the
    path every shape can fall back to: the shared memory a block needs,
    the most the card lets a block have, and how many clusters of C such
    blocks can be resident. Builds the kernel on first use; asks the
    runtime once a shape and card."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _solve_fits(N, n, m, R, C, index)


@functools.lru_cache(maxsize=1024)
def _solve_fits(N: int, n: int, m: int, R: int, C: int, index: int) -> tuple:
    fn = build.function("clipper_solve", "clipper_solve_fits",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    need, avail, clusters = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(index):
        err = fn(N, n, m, R, C, ctypes.byref(need), ctypes.byref(avail),
                 ctypes.byref(clusters))
    build.check_launch("clipper_solve_fits", err)
    return need.value, avail.value, clusters.value


def check_solve_shape(n: int, m: int, R: int, P: int, device) -> None:
    """Raise ValueError unless the kernel takes P pairs of N = n*m
    associations at R restarts on this card: u, its bf16 copy and the
    valid mask (2R*N + N floats) live in each block's shared memory, which
    caps N (about 18,000 at R = 1 on an H100)."""
    C = cluster_size(P, torch.cuda.get_device_properties(device).multi_processor_count)
    need, avail, clusters = solve_fits(n * m, n, m, R, C, device)
    if need > avail or clusters < 1:
        raise ValueError(
            f"clipper_solve takes N = n*m only while its vectors fit a block's "
            f"shared memory: N = {n * m} ({n} x {m}) at {R} restart(s) and {C} "
            f"blocks a pair needs {need} bytes, the card allows {avail}")


def clipper_solve(M: torch.Tensor, valid: torch.Tensor, n: int, m: int,
                  params: ClipperSolveParams = ClipperSolveParams()):
    """CLIPPER solve of every pair: launches the CUDA kernel for CUDA
    tensors, runs the plain twin for CPU tensors.

    M (P, N, N) bf16 contiguous, valid (P, N) f32 contiguous, N = n*m.
    Returns u (P, N), d (P,), F (P,), omega (P,).
    """
    if M.device.type == "cpu":
        return clipper_solve_plain(M, valid, n, m, params)
    P, N = M.shape[0], n * m
    dev = M.device
    build.check_tensor("M", M, (P, N, N), torch.bfloat16, dev)
    build.check_tensor("valid", valid, (P, N), torch.float32, dev)
    R = params.n_restarts
    if not 1 <= R <= MAX_RESTARTS:
        raise ValueError(f"n_restarts must be in [1, {MAX_RESTARTS}], got {R}")
    if dev.type == "cuda":  # a card's limit; other devices (meta) have none
        check_solve_shape(n, m, R, P, dev)
    noise = device_noise(R, N, dev)
    u = torch.empty((P, N), dtype=torch.float32, device=dev)
    d = torch.empty(P, dtype=torch.float32, device=dev)
    F = torch.empty(P, dtype=torch.float32, device=dev)
    omega = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return u, d, F, omega
    C = cluster_size(P, torch.cuda.get_device_properties(dev).multi_processor_count)
    # each pair's (live rows, every block resident, compact), only while tracing
    stats = (torch.empty((P, 3), dtype=torch.int32, device=dev)
             if tracing.recording() else None)
    region = compact_words(N, C)
    scratch = torch.empty(P * C * region, dtype=torch.int32, device=dev)
    fn = build.function("clipper_solve", "clipper_solve_launch",
                        [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(M.data_ptr(), valid.data_ptr(), noise.data_ptr(),
                 u.data_ptr(), d.data_ptr(), F.data_ptr(), omega.data_ptr(),
                 None if stats is None else stats.data_ptr(), scratch.data_ptr(),
                 region, P, N, n, m, R, params.warmup_iters, params.outer_iters,
                 params.inner_iters, C, params.active_eps,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("clipper_solve", err)
    clipper_solve.launches += 1
    if stats is not None:
        tracing.count("solve.pairs", P)
        tracing.count_device("solve.live_rows", stats[:, 0])
        tracing.count_device("solve.resident_pairs", stats[:, 1])
        tracing.count_device("solve.compact_pairs", stats[:, 2])
    return u, d, F, omega


clipper_solve.launches = 0
