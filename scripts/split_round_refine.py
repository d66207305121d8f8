#!/usr/bin/env python3
"""Phase split of the round_refine kernel on one CUDA card.

Run from the root of a checkout of the port (its own ``chip_smoke.py``,
``roman_tpu_torch`` and ``csrc/fused_register.cu`` are used, so the same
script splits an older checkout's kernel too):

    python3 scripts/split_round_refine.py [label]

It copies the round_refine section of the checkout's
``csrc/fused_register.cu`` into ``build/split_round_refine/``, inserts a
``clock64()`` stamp at each phase boundary (thread 0 of each block, after
a block barrier, so a stamp costs a barrier), builds the copy with the
checkout's nvcc flags beside an empty kernel, and runs it on the bench
chunk of ``chip_smoke.py`` phase 2 (32 pairs, n = m = 40, N = 1600, the
plain solve's outputs). It prints one JSON line: the card; kilocycles of
each phase a block (min, median, max over the blocks); the SM clock from
the stamps against ``%globaltimer``; C (entries above the rounding's cut)
and K (entries it selects) per pair; the device times of the stamped
copy, of the kernel and of an empty kernel on as many blocks, in one
profiler window; and whether the copy selects what the kernel does.

It knows two forms of the kernel: the greedy arg-max steps of its first
version and the sorted scan with a tile refinement that replaced them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

STAMP = "  ROUND_STAMP({});\n"
# (text after which a stamp goes, the phase that ends there), in order
ANCHORS = {
    "steps": [
        ("      : (float)q.max_steps;\n", "load u, max"),
        ("    __syncthreads();\n  }\n\n  // ---- support refinement on the selected set ----\n",
         "rounding steps"),
        ("  __syncthreads();\n  const int K = n_sel;\n", "sort"),
        ("        alive[k] = alive[k] && supp[k] >= thresh && !(drop && k == worst);\n"
         "    }\n    __syncthreads();\n", "refinement iteration"),
    ],
    "scan": [
        ("      : (float)q.max_steps;\n", "max"),
        ("    round_compact(U, N, cut, lo, kNoKey, keys, band, &n_keys);\n"
         "    __syncthreads();\n", "compaction"),
        ("    round_sort(keys, P2);\n", "sort"),
        ("      if (lane == 0) n_sel = taken;\n    }\n    __syncthreads();\n", "walk"),
        ("    order[r] = me;\n  }\n  __syncthreads();\n", "rank"),
        ("      if (e < KK) tile[e] = v[t];\n    }\n  }\n  __syncthreads();\n", "gather"),
        ("    else round_refine_warp<8>(tile, K, q, tgt, alive, supp, count);\n  }\n",
         "refinement"),
    ],
}
MAX_STAMPS = 32

PRELUDE = r"""#include <cstdint>
#include "common.cuh"
namespace {
__device__ __forceinline__ long long round_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
// stamp i: phase id, then clock64(); slots 2 MAX_STAMPS.. hold the
// globaltimer at the start and the end and the number of stamps
#define ROUND_STAMP(id) do { __syncthreads(); if (threadIdx.x == 0 && si_ < %(M)d) { \
  st_[2 * si_] = (id); st_[2 * si_ + 1] = clock64(); } ++si_; } while (0)
struct RoundParams {
  int n, m, max_steps, refine_iters;
  float rel_thresh, min_support, rel_support, edge_eps;
};
""".replace("%(M)d", str(MAX_STAMPS))

LAUNCH = r"""
__global__ void empty_kernel() {}
}  // namespace

extern "C" int empty_launch(int P, void* stream) {
  empty_kernel<<<P, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int stamped_launch(const void* M, const void* u, const void* F,
                              const void* omega, void* sel, void* count, void* stamps,
                              int P, int n, int m, int max_steps, int refine_iters,
                              float rel_thresh, float min_support, float rel_support,
                              float edge_eps, void* stream) {
  RoundParams q{n, m, max_steps, refine_iters, rel_thresh, min_support,
                rel_support, edge_eps};
  SMEM_AND_LAUNCH
  return (int)cudaGetLastError();
}
"""
SMEM = {
    "steps": """const size_t smem = sizeof(float) * (size_t)n * m;
  if (smem > 32 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        round_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  round_refine_kernel<<<P, 256, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)M, (const float*)u, (const float*)F, (const float*)omega,
      (unsigned char*)sel, (int*)count, q, (long long*)stamps);""",
    "scan": """const int band = round_band(n * m);
  const size_t smem = sizeof(unsigned long long) * band +
                      sizeof(__nv_bfloat16) * (size_t)max_steps * max_steps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        round_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  round_refine_kernel<<<P, kRoundThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)M, (const float*)u, (const float*)F, (const float*)omega,
      (unsigned char*)sel, (int*)count, q, band, (long long*)stamps);""",
}


def stamped_source(src: str):
    """The round_refine section of fused_register.cu with stamps, as a
    standalone source; and the names of the phases by stamp id."""
    a = src.index("// round_refine:")
    a = src.rindex("// ----", 0, a)
    b = src.index("}  // namespace", a)
    sec = src[a:b]
    form = "scan" if "round_band(" in sec else "steps"
    names = ["start"]
    for text, name in ANCHORS[form]:
        if sec.count(text) != 1:
            raise RuntimeError(f"anchor for {name!r} found {sec.count(text)} times")
        names.append(name)
        sec = sec.replace(text, text + STAMP.format(len(names) - 1))
    # the stamps buffer: one more kernel argument; a stamp at the start and
    # one at the end with the globaltimer beside them
    head = "RoundParams q) {" if form == "steps" else "RoundParams q, int band) {"
    if sec.count(head) != 1:
        raise RuntimeError("kernel signature not found")
    sec = sec.replace(head, head[:-3] + ", long long* stamps_) {\n"
                      "  long long* st_ = stamps_ + (size_t)blockIdx.x * (2 * %d + 4);\n"
                      "  int si_ = 0;\n  if (threadIdx.x == 0) st_[2 * %d] = round_gtime();\n"
                      "  ROUND_STAMP(0);\n" % (MAX_STAMPS, MAX_STAMPS))
    end = sec.rstrip().rindex("}")
    names.append("output")
    sec = (sec[:end] + STAMP.format(len(names) - 1)
           + "  if (threadIdx.x == 0) { st_[2 * %d + 1] = round_gtime(); "
             "st_[2 * %d + 2] = si_; }\n}\n" % (MAX_STAMPS, MAX_STAMPS))
    return PRELUDE + sec + LAUNCH.replace("SMEM_AND_LAUNCH", SMEM[form]), names


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from roman_tpu_torch.align import clipper
    from roman_tpu_torch.align import fused_register as fr
    from roman_tpu_torch.align.clipper_solve import clipper_solve_plain
    from roman_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("split_round_refine.py needs a CUDA card", file=sys.stderr)
        return 1
    build.build_all()
    src, names = stamped_source((build.SRC_DIR / "fused_register.cu").read_text())
    out_dir = build.BUILD_DIR.parent / "split_round_refine"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "stamped.cu").write_text(src)
    so = out_dir / "libstamped.so"
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
                        "-o", str(so), str(out_dir / "stamped.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stamped_launch.argtypes = [P_] * 7 + [I_] * 5 + [F_] * 4 + [P_]
    lib.stamped_launch.restype = I_
    lib.empty_launch.argtypes = [I_, P_]
    lib.empty_launch.restype = I_

    dev = torch.device("cuda")
    _, maps = cs.make_world()
    _, feats, auxs, cfg = cs.grid_features(maps, dev)
    pi, pj = cs.kernel_pairs(auxs)
    f1 = feats[0].map(lambda x: x[torch.as_tensor(pi, device=dev)].contiguous())
    f2 = feats[1].map(lambda x: x[torch.as_tensor(pj, device=dev)].contiguous())
    P, n, m = len(pi), f1.capacity, f2.capacity
    inv = fr.FusedInvariantStatics(cos_min=cfg.cos_min, cos_max=cfg.cos_max,
                                   max_clique=cfg.max_clique)
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    hl, nz, single, vflat = fr.assoc_terms_plain(
        f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors, valid, inv)
    M = fr.build_affinity_plain(f1.centers, f2.centers, hl, nz, single, vflat, inv)
    u, _, F, om = clipper_solve_plain(M, vflat, n, m, cfg.solver)
    max_steps = min(inv.max_clique, n, m)
    C = ((u > inv.rel_thresh * u.amax(dim=1, keepdim=True)) & (u > 0)).sum(1)
    _, K = clipper.round_greedy(u.reshape(P, n, m), F, max_steps, inv.rel_thresh)

    sel = torch.empty((P, n * m), dtype=torch.bool, device=dev)
    count = torch.empty(P, dtype=torch.int32, device=dev)
    stamps = torch.zeros((P, 2 * MAX_STAMPS + 4), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def stamped():
        err = lib.stamped_launch(M.data_ptr(), u.data_ptr(), F.data_ptr(), om.data_ptr(),
                                 sel.data_ptr(), count.data_ptr(), stamps.data_ptr(),
                                 P, n, m, max_steps, inv.refine_iters, inv.rel_thresh,
                                 inv.min_support, inv.rel_support, inv.edge_eps, stream)
        build.check_launch("stamped round_refine", err)

    def empty():
        build.check_launch("empty", lib.empty_launch(P, stream))

    def kernel():
        return fr.round_refine(M, u, F, om, n, m, inv)

    for fn in (stamped, empty, kernel):  # warmup
        fn()
    ref = kernel()
    stamped()
    torch.cuda.synchronize()
    same = torch.equal(sel, ref[0]) and torch.equal(count, ref[1])
    st = stamps.cpu().numpy().astype(np.int64)
    used = int(st[0, 2 * MAX_STAMPS + 2])
    ids = st[:, 0:2 * used:2]
    clk = st[:, 1:2 * used:2].astype(float)
    phases = {}
    for k in range(1, used):
        name = names[int(ids[0, k])]
        d = clk[:, k] - clk[:, k - 1]
        phases.setdefault(name, []).append(d)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "card": cs.nvidia_smi(), "same_as_kernel": same, "stamps": used}
    for name, ds in phases.items():
        d = np.stack(ds)  # (times the phase ran, blocks)
        tot = d.sum(0) / 1e3
        out[f"{name}_kcycles"] = [float(tot.min()), float(np.median(tot)), float(tot.max())]
        if len(ds) > 1:
            out[f"{name}_kcycles_each_median"] = [float(np.median(x)) / 1e3 for x in ds]
    ns = (st[:, 2 * MAX_STAMPS + 1] - st[:, 2 * MAX_STAMPS]).astype(float)
    cyc = clk[:, used - 1] - clk[:, 0]
    out["sm_ghz_median"] = float(np.median(cyc / ns))
    out["block_us"] = [float(ns.min()) / 1e3, float(np.median(ns)) / 1e3,
                       float(ns.max()) / 1e3]
    for name, v in (("C", C), ("K", K)):
        v = v.cpu().numpy()
        out[name] = [int(v.min()), float(np.median(v)), int(v.max())]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            empty()
            stamped()
            kernel()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            what = ("empty" if "empty_kernel" in e.key else
                    "stamped" if "long long" in e.key else "kernel")
            out[f"device_ms_{what}"] = e.self_device_time_total / 10 / 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
