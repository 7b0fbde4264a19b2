"""Where the time of the sLSTM backward's cluster layout goes, on the card:
the kernel before its redesign (commit 8326434) with each part removed in
turn, and the order in which the redesigned loop takes a cluster's rows.

    git show 8326434:src/repro_torch/kernels/slstm_scan/csrc/slstm_scan.cu \\
        > build/split/slstm_scan.cu
    PYTHONPATH=src python -m repro_torch.launch.slstm_bwd_split build/split/slstm_scan.cu
    PYTHONPATH=src python -m repro_torch.launch.slstm_bwd_split --orders

With a path, the argument is a copy of that commit's ``slstm_scan.cu`` (the
cluster kernel ``slstm_scan_bwd_cluster_kernel`` before its redesign). Each
variant is that text with one edit (``VARIANTS``), written beside the copy
and built with nvcc into its own library:

- ``whole``: unchanged;
- ``no_rest``: no ``step_rest`` and none of its three stores (the terms
  only it reads, ``qnn`` and ``lsg``, fall away with it);
- ``no_rest_terms``: ``step_rest`` kept, ``qnn`` and ``lsg`` constants;
- ``no_loads``: the loads of step t - 1 replaced by one product each of the
  value in hand;
- ``no_product``: one read of dz_pre a lane in place of the products (the
  serial floor with the chain and the rest);
- ``floor``: the revision's own serial floor (``serial_floor`` 1).

With ``--orders``, the variants are the checkout's own source with the
redesigned loop taking a cluster's rows in another order (``ORDERS``),
written under ``build/split/``: ``pairs`` (the source as it is: a warp
waits for two rows and sums both rows' products together), ``in_turn``
(wait, products, chain and send of one row, then the next) and
``each_waited`` (each row waited for just before its own products; the two
rows' reduce-scatters, chains and sends together). Each loop
(``slstm_scan_bwd_launch``, cluster layout) and its serial floor are timed,
and every variant's dzx and dh0 are checked equal bit for bit to ``pairs``'.

Each is timed at (8, 512, 768) float32 in the cluster layout with
``launch.timing.time_cuda`` (median of 15, L2 flushed), twice in the order
first, variants, first. The forward (``ops.slstm_scan``, cluster layout)
is timed beside them. Prints one line a variant and the card's name and
power limit. Needs a card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["ORDERS", "VARIANTS", "main"]

_REST = ("    if (!kFloor && mine) {\n      float dix, dfx, dox;\n      step_rest(",
         "    if (!kFloor && mine && false) {\n      float dix, dfx, dox;\n      step_rest(")
_TERMS = ("    if (!kFloor && mine) k = step_terms(ix, fx, ox, c, n, m, z, mp);\n",
          "    if (!kFloor && mine) k = step_terms(ix, fx, ox, c, n, m, z, mp);\n"
          "    k.qnn = 0.5f;\n    k.lsg = 0.25f;\n")
_LOADS = ("""      nix = __ldg(a.ix + g);
      nfx = __ldg(a.fx + g);
      nox = __ldg(a.ox + g);
      if (a.dhs) ngin = __ldg(a.dhs + g);
      nz = __ldg(a.zs + g);
      ncp = t > 1 ? __ldg(a.cs + g - d) : a.c0[sidx];
      nnp = t > 1 ? __ldg(a.ns + g - d) : a.n0[sidx];
      nmp = t > 1 ? __ldg(a.ms + g - d) : a.m0[sidx];
""", """      (void)g;
      nix = ix * 0.999f;
      nfx = fx * 0.999f;
      nox = ox * 0.999f;
      ngin = gin * 0.999f;
      nz = z * 0.999f;
      ncp = cp * 0.999f;
      nnp = np * 0.999f;
      nmp = mp * 0.999f;
""")
_PRODUCT = ("      carry = kFloor ? xc[(mine ? r : 0) * dp + (mine ? c0 + jl : c0)]\n"
            "                     : cluster_row_dot(xc, nr, r, lane, w);\n",
            "      carry = xc[(mine ? r : 0) * dp + (mine ? c0 + jl : c0)];\n")
# name -> (its edits, each (anchor, replacement), and the serial_floor flag)
VARIANTS = {"whole": ((), 0), "no_rest": ((_REST,), 0), "no_rest_terms": ((_TERMS,), 0),
            "no_loads": ((_LOADS,), 0), "no_product": ((_PRODUCT,), 0), "floor": ((), 1)}

# The redesigned loop's step from its wait to its sends, as the source has
# it: the products (_STEP), then the chain and the sends.
_STEP = """    if (s > 0) {
      carry = bwd_row_dots<kFloor>(xbuf + cur * R * dp, bars + 8 * cur * R, nr,
                                   static_cast<unsigned>((s - 1) >> 1) & 1u, true, row_bytes, r,
                                   col, lane, w);
    }
"""
_STEP_ALL = _STEP + """    float da = carry;
    if (!kFloor && mine) {
      const float g = a.dhs ? __fadd_rn(gin, carry) : carry;
      float dq, dcp;
      da = step_chain(k, g, dc, dq, dcp);
      dc = __fmul_rn(dcp, k.f_p);
      a.dzx[g0 + t * d] = da;
      a.gs[g0 + t * d] = g;
    }
    const int nxt = cur ^ 1;
    for (int rr = 0; rr < nr; ++rr) {
      cluster_send_row(da, x_u32 + 4u * (nxt * R + rr) * dp, bars + 8 * (nxt * R + rr), C, rr, c0,
                       wc, warp, lane);
    }
"""
_IN_TURN = """    const int nxt = cur ^ 1;
    for (int rr = 0; rr < nr; ++rr) {
      float dot = 0.0f;
      if (s > 0) {
        const unsigned bar = bars + 8 * (cur * R + rr);
        mbar_wait(bar, static_cast<unsigned>((s - 1) >> 1) & 1u);
        if (threadIdx.x == 0) mbar_expect(bar, row_bytes);
        const float* xr = xbuf + (cur * R + rr) * dp;
        if (kFloor) {
          dot = xr[col];
        } else {
          float sum[1];
          cluster_dots<1>(xr, lane, w, sum);
          dot = sum[0];
        }
      }
      float da = dot;
      if (!kFloor && mine && r == rr) {
        if (s > 0) carry = dot;
        const float g = a.dhs ? __fadd_rn(gin, carry) : carry;
        float dq, dcp;
        da = step_chain(k, g, dc, dq, dcp);
        dc = __fmul_rn(dcp, k.f_p);
        a.dzx[g0 + t * d] = da;
        a.gs[g0 + t * d] = g;
      }
      cluster_send_row(da, x_u32 + 4u * (nxt * R + rr) * dp, bars + 8 * (nxt * R + rr), C, rr, c0,
                       wc, warp, lane);
    }
"""
_EACH_WAITED = """    if (s > 0) {
      float dot = 0.0f;
      for (int rr = 0; rr < nr; rr += 2) {
        const bool two = rr + 1 < nr;
        const unsigned par = static_cast<unsigned>((s - 1) >> 1) & 1u;
        const unsigned bar = bars + 8 * (cur * R + rr);
        const float* xr = xbuf + (cur * R + rr) * dp;
        mbar_wait(bar, par);
        if (threadIdx.x == 0) mbar_expect(bar, row_bytes);
        if (kFloor) {
          if (two) mbar_wait(bar + 8, par);
          if (two && threadIdx.x == 0) mbar_expect(bar + 8, row_bytes);
          if (r == rr || r == rr + 1) dot = xr[(r - rr) * dp + col];
          continue;
        }
        float acc0[kWarpCols], acc1[kWarpCols] = {};
        row_products(xr, lane, w, acc0);
        if (two) {
          mbar_wait(bar + 8, par);
          if (threadIdx.x == 0) mbar_expect(bar + 8, row_bytes);
          row_products(xr + dp, lane, w, acc1);
        }
        const float s0 = reduce_columns(acc0, lane);
        const float s1 = two ? reduce_columns(acc1, lane) : 0.0f;
        if (r == rr) dot = s0;
        if (r == rr + 1) dot = s1;
      }
      carry = dot;
    }
"""
_KERNEL = ("template <bool kFloor>\n__global__ void __launch_bounds__(kCThreads, 1) "
           "slstm_scan_bwd_cluster_kernel(BwdArgs a) {")
# One row's products, as cluster_dots sums each row, and its reduce-scatter.
_HELPERS = """__device__ __forceinline__ void row_products(const float* hr, int lane,
                                             const float (&w)[kWarpCols][kLaneK],
                                             float (&acc)[kWarpCols]) {
  for (int q = 0; q < kWarpCols; ++q) acc[q] = 0.0f;
  hr += 4 * lane;
#pragma unroll
  for (int i = 0; i < kLaneK / 4; ++i) {
    const float4 hv = *reinterpret_cast<const float4*>(hr + 128 * i);
    const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int q = 0; q < kWarpCols; ++q) acc[q] = fmaf(h4[e], w[q][4 * i + e], acc[q]);
    }
  }
}

__device__ __forceinline__ float reduce_columns(const float (&acc)[kWarpCols], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float k0 = hi16 ? acc[2] : acc[0];
  float k1 = hi16 ? acc[3] : acc[1];
  const float s0 = hi16 ? acc[0] : acc[2];
  const float s1 = hi16 ? acc[1] : acc[3];
  k0 = __fadd_rn(k0, __shfl_xor_sync(0xffffffffu, s0, 16));
  k1 = __fadd_rn(k1, __shfl_xor_sync(0xffffffffu, s1, 16));
  float v = hi8 ? k1 : k0;
  const float sv = hi8 ? k0 : k1;
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, sv, 8));
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

""" + _KERNEL
# name -> its edits of the checkout's source
ORDERS = {"pairs": (), "in_turn": ((_STEP_ALL, _IN_TURN),),
          "each_waited": ((_STEP, _EACH_WAITED), (_KERNEL, _HELPERS))}

# That commit's slstm_scan_bwd_launch: device, 24 pointers (the gradients, inputs,
# saved steps and outputs), B, S, d, layout, C, R, serial_floor, stream.
_OLD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 24 + [ctypes.c_longlong] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _library(source: Path, name: str, edits, argtypes, out_dir: Path):
    """``source`` with ``edits`` applied, written to ``out_dir`` and built:
    (its slstm_scan_bwd_launch, the copy's path)."""
    from repro_torch.kernels import _build

    text = source.read_text()
    for anchor, replacement in edits:
        if text.count(anchor) != 1:
            raise ValueError(f"{source} is not the revision this script edits: {name}'s "
                             f"anchor is not there once")
        text = text.replace(anchor, replacement)
    copy = out_dir / f"{source.stem}_{name}.cu"
    copy.write_text(text)
    return _build.load_library(copy, "slstm_scan_bwd_launch", argtypes).slstm_scan_bwd_launch, copy


def _inputs(B, S, d, seed=23):
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gates = [torch.randn(B, S, d, device="cuda", generator=gen) for _ in range(4)]
    rw = torch.randn(d, d, device="cuda", generator=gen) * d ** -0.5
    state = (*(torch.zeros(B, d, device="cuda") for _ in range(3)),
             torch.full((B, d), -1e30, device="cuda"))
    fwd = (*gates, rw, *state)
    saved = slstm_scan_ref(*fwd, save=True)[5:]
    grads = [torch.randn(B, S, d, device="cuda", generator=gen)] + [
        torch.randn(B, d, device="cuda", generator=gen) for _ in range(4)]
    return fwd, [*grads, *gates[1:], rw, *state[:2], state[3], *saved]


def main(argv: list[str] | None = None) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm_scan import kernel, ops
    from repro_torch.launch.timing import time_cuda

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", type=Path, nargs="?", help="a copy of commit 8326434's slstm_scan.cu")
    ap.add_argument("--orders", action="store_true",
                    help="time the checkout's loop with a cluster's rows in other orders")
    ap.add_argument("--shape", type=int, nargs=3, default=(8, 512, 768), metavar=("B", "S", "d"))
    args = ap.parse_args(argv)
    if args.orders == (args.source is not None):
        ap.error("give either a copy of commit 8326434's source or --orders")
    if args.orders:  # the checkout's source; its launch takes the loop's dh_t scratch
        source, out_dir = kernel.SOURCE, kernel.SOURCE.parents[5] / "build" / "split"
        edits, argtypes = ORDERS, kernel._BWD_ARGTYPES
        runs = [(name, flag) for name in ORDERS for flag in (0, 1)]
    else:
        source, out_dir = args.source, args.source.parent
        edits, argtypes = {name: e for name, (e, _) in VARIANTS.items()}, _OLD_ARGTYPES
        runs = [(name, flag) for name, (_, flag) in VARIANTS.items()]
    B, S, d = args.shape
    fwd, bwd = _inputs(B, S, d)
    p = ops.plan(B, S, d, ops.device(), "cluster")
    out = [torch.empty_like(bwd[5]) for _ in range(4)] + [torch.empty_like(bwd[9])
                                                           for _ in range(4)]
    scratch = [torch.empty_like(bwd[5])] if args.orders else []
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(edits)) as pool:  # one nvcc a variant, all at once
        libs = dict(zip(edits, pool.map(
            lambda name: _library(source, name, edits[name], argtypes, out_dir), edits)))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [None if t is None else t.data_ptr() for t in bwd]

    def launcher(name, floor):
        fn = libs[name][0]

        def run():
            err = fn(0, *ptrs, *(t.data_ptr() for t in out + scratch), B, S, d, 1, p["C"],
                     p["R"], floor, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
        return run

    if args.orders:
        first = None
        for name in edits:
            launcher(name, 0)()
            torch.cuda.synchronize()
            got = (out[0].clone(), out[6].clone())
            first = first or (name, got)
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(got, first[1]))
            print(f"  {name}: dzx and dh0 {'equal' if same else 'NOT equal'} bit for bit to "
                  f"{first[0]}'s")
    times = {run: [] for run in runs}
    for order in (runs, runs[::-1]):
        for name, flag in order:
            times[(name, flag)].append(time_cuda(launcher(name, flag)))
    fwd_ms = time_cuda(lambda: ops.slstm_scan(*fwd, layout="cluster"))
    what = "the loop's row orders" if args.orders else "the kernel of 8326434, parts removed"
    print(f"slstm_scan_bwd cluster layout at (B, S, d) = ({B}, {S}, {d}) float32, C = {p['C']}, "
          f"R = {p['R']}, {p['clusters']} clusters: {what}; ms in two rounds")
    base = sum(times[runs[0]]) / 2
    for (name, flag), (a, b) in times.items():
        mean = (a + b) / 2
        label = f"{name} floor" if flag and args.orders else name
        print(f"  {label:18s} {a:.4f} {b:.4f} ms; mean {mean:.4f}, {1e3 * mean / S:.3f} us a "
              f"step, {base - mean:+.4f} ms against {runs[0][0]}")
    print(f"  forward (slstm_scan, cluster) {fwd_ms:.4f} ms")
    for name in edits:
        entry = ""
        for line in _build.build_info(libs[name][1]).get("log", "").splitlines():
            entry = line if "entry function" in line else entry
            if "registers" in line and "bwd_cluster_kernelILb0" in entry:
                print(f"  ptxas, {name}: {line.strip()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
