// Kernel A: one RK stage of 3-D Newtonian ideal MHD from (u, bfc).
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_mega_stage3d_v2: bcc
// from the face fields, c2p with the floors (the floored u is the RK
// base), PLM + face-state floors + HLLD in x1/x2/x3, the flux-divergence
// update gam0*u + gam1*u1 - beta_dt*div(F), Gardiner-Stone 2007 corner
// EMFs, constrained transport on the three face fields, output c2p with
// the floors, the floor counts and max(|v| + c_f) per direction over the
// interior cells.  Plain version: ops/stage.py::mega_stage_v2_plain.
//
// What bounds it on the H100: arithmetic and its latency.  The stage
// moves 24 values a cell (u, u1, the face fields and their RK register
// in; u' and the new faces out), 0.06 ms at 124^3; the HLLD body alone is
// some 250 flops and a dozen IEEE divisions and square roots a face,
// three faces a cell.
// The first design chained six launches through 32 scratch values a cell
// in device memory and ran the input c2p twice; its update launch,
// reading some 70 scattered values a cell, took 37% of the stage and its
// three flux launches 49%.
//
// This design is one launch (after the zeroing of the 6-word reduction
// buffer), and, like the TPU kernel's (K+4)-plane window, keeps w, bcc,
// the fluxes and the EMFs on chip.  A CUDA block owns a tile of TJ x TI
// interior columns of one MeshBlock and a segment of planes along k
// (csrc/stage_tile.cuh: the cut, the halos and the shared memory) and
// marches through its planes, u and the face fields read from device
// memory once, steps ahead of use, by cp.async into a ring of raw planes
// in shared memory.  At step p it
//   B. runs PLM + floors + HLLD once for each of the tile's x1 and x2
//      faces of plane p and x3 faces of face plane p, plus the row or
//      column the corner EMFs reach (one work list over the three
//      directions, so the block's threads share it evenly);
//   C. adds the flux divergence to the floored input state of plane
//      p-1 (the RK update, one item a cell and component), and computes
//      the GS07 corner EMFs e1, e2 of edge plane p and e3 of plane p-1;
//   D. on one thread a cell of plane p-1: CT of the cell's faces, the
//      output bcc (faces (i, i+1), as the port's other kernels) and c2p,
//      the writes of u' and the new faces, the floor counts and dt
//      maxima (reduced per block at the end of the march).  The other
//      threads load u1 of plane p and the raw plane p+3 and compute
//      bcc and c2p of plane p+2 (A) over the tile and a halo of two
//      cells, keeping w, bcc (a ring of four planes) and the floored u
//      (the RK base: the input c2p runs once a cell).
// The march is bound by latency: 127 registers a thread hold two blocks
// of 8 warps on an SM, and the IEEE divisions and square roots of HLLD
// (some 21 a face) and of the update form long dependent chains.  Work
// lists that keep all of a block's threads busy in every phase, and the
// merge of A into D, took it from 1.06 to 0.95 ms at 124^3 on an H100
// 80GB HBM3 at 700 W (PERF.md).
// The numerics are those of the first design, term by term and in the
// same order (hlld.cuh, c2p, gs07, the update and CT terms), so in f32
// the result is bitwise equal to it.
//
// Ghost cells and faces of the outputs are left as they are; the fill
// kernel (periodic_fill.cu, pool_fill.cu) or the general sweep fill
// writes them.

#include "async_copy.cuh"
#include "mhd_stage.cuh"
#include "stage_tile.cuh"

namespace athenak {
namespace {

// Adds the block's floor counts fl[0..2] (sums over each thread's cells)
// to red[0..2] and raises red[3..5] to the bit pattern of the block's max
// of dv[0..2] (positive floats order like their bit patterns); red is
// zeroed before the launch.
template <typename T, int NT>
__device__ __forceinline__ void block_sum_max(const int fl[3], const T dv[3],
                                              unsigned long long* red) {
  __shared__ int scnt[3][NT / 32];
  __shared__ T smax[3][NT / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int c = 0; c < 3; ++c) {
    int n = fl[c];
    T v = dv[c];
    for (int off = 16; off > 0; off >>= 1) {
      n += __shfl_xor_sync(0xffffffffu, n, off);
      v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    if (lane == 0) {
      scnt[c][wid] = n;
      smax[c][wid] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < 3; ++c) {
      int n = scnt[c][0];
      T v = smax[c][0];
      for (int w = 1; w < NT / 32; ++w) {
        n += scnt[c][w];
        v = tmax(v, smax[c][w]);
      }
      if (n) atomicAdd(&red[c], static_cast<unsigned long long>(n));
      atomicMax(&red[3 + c], max_bits<T>(v));
    }
  }
}

template <typename T>
struct StageArgs {
  const T *u, *b1, *b2, *b3, *u1, *b1o, *b2o, *b3o;
  T *uo, *b1n, *b2n, *b3n;
  unsigned long long* red;
};

template <typename T, int TJ, int TI, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    stage_kernel(StageArgs<T> a, Dims g, Eos<T> eos, Coef cf, TileGeom geo) {
  constexpr StageSmem L = stage_smem(TJ, TI);
  constexpr TileRange RP = prim_range(TJ, TI);
  constexpr TileRange R1 = flux_range(0, TJ, TI), R2 = flux_range(1, TJ, TI),
                      R3 = flux_range(2, TJ, TI);
  constexpr TileRange Q1 = edge_range(0, TJ, TI), Q2 = edge_range(1, TJ, TI),
                      Q3 = edge_range(2, TJ, TI);
  constexpr int HJ = RP.nj, HI = RP.ni, HC = HJ * HI;
  constexpr int N1F = range_size(R1), N2F = range_size(R2),
                N3F = range_size(R3);
  constexpr int NE1 = range_size(Q1), NE2 = range_size(Q2),
                NE3 = range_size(Q3);
  // the march below keeps rings of 4 primitive planes and 2 flux and edge
  // planes, which these k ranges need
  constexpr int PK0 = kPrimK.lo, PK1 = kPrimK.hi;
  constexpr int FK0 = kFluxK12.lo, FK1 = kFluxK12.hi, F3K0 = kFluxK3.lo;
  constexpr int EK0 = kEdgeK12.lo, E3K0 = kEdgeK3.lo, E3K1 = kEdgeK3.hi;
  static_assert(PK0 == -2 && PK1 == 2 && FK0 == -1 && FK1 == 1 &&
                    F3K0 == 0 && kFluxK3.hi == 1 && EK0 == 0 &&
                    kEdgeK12.hi == 1 && E3K0 == 0 && E3K1 == 0,
                "the rings of the march assume these k ranges");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const prim = sm + L.prim;    // [4][8][HC]
  T* const u0s = sm + L.u0;       // [4][5][TJ * TI]
  T* const f1 = sm + L.f1;        // [2][7][N1F]
  T* const f2 = sm + L.f2;        // [2][7][N2F]
  T* const f3 = sm + L.f3;        // [2][7][N3F]
  T* const e1 = sm + L.e1;        // [2][NE1]
  T* const e2 = sm + L.e2;        // [2][NE2]
  T* const e3 = sm + L.e3;        // [NE3]
  T* const stage = sm + L.stage;  // [3][L.stage_slot]
  T* const rk = sm + L.rk;        // u1, b, b_old of the tile's faces

  const TileBox box = tile_box(geo, blockIdx.x);
  const int m = box.m, ks = box.k0, ke = box.k1;
  const int j0 = box.j0, i0 = box.i0;
  const int tid = threadIdx.x;

  // raw plane c (u, b1, b2 and the x3 faces c and c+1) into its stage
  // slot; reads outside the array (a ragged tile's halo) are clamped
  auto stage_load = [&](int c, int first, int stride) {
    T* st = stage + (c % 3) * L.stage_slot;
    constexpr int NU = 5 * HC, NB1 = HJ * (HI + 1), NB2 = (HJ + 1) * HI;
    constexpr int NALL = NU + NB1 + NB2 + 2 * HC;
    const int jb = j0 + RP.j_lo, ib = i0 + RP.i_lo;
    for (int e = first; e < NALL; e += stride) {
      const T* src;
      if (e < NU) {
        const int comp = e / HC, h = e % HC;
        const int j = clampi(jb + h / HI, 0, g.n2 - 1);
        const int i = clampi(ib + h % HI, 0, g.n1 - 1);
        src = a.u + cidx(g, m, comp, 5, c, j, i);
      } else if (e < NU + NB1) {
        const int h = e - NU;
        const int j = clampi(jb + h / (HI + 1), 0, g.n2 - 1);
        const int i = clampi(ib + h % (HI + 1), 0, g.n1);
        src = a.b1 + f1idx(g, m, c, j, i);
      } else if (e < NU + NB1 + NB2) {
        const int h = e - NU - NB1;
        const int j = clampi(jb + h / HI, 0, g.n2);
        const int i = clampi(ib + h % HI, 0, g.n1 - 1);
        src = a.b2 + f2idx(g, m, c, j, i);
      } else {
        const int h = e - NU - NB1 - NB2;
        const int kk = c + h / HC;
        const int j = clampi(jb + (h % HC) / HI, 0, g.n2 - 1);
        const int i = clampi(ib + h % HI, 0, g.n1 - 1);
        src = a.b3 + f3idx(g, m, kk, j, i);
      }
      cp_async<sizeof(T)>(st + e, src);
    }
  };

  // what the update of plane k reads besides the fluxes and EMFs: u1 of
  // the tile's cells, and b and the RK register b_old of their faces
  constexpr int RU = 5 * TJ * TI, RB1 = TJ * (TI + 1), RB2 = (TJ + 1) * TI,
                RB3 = 2 * TJ * TI;
  auto u1_load = [&](int k, int first, int stride) {
    for (int e = first; e < RU; e += stride) {
      const int comp = e / (TJ * TI), t = e % (TJ * TI);
      const int j = min(j0 + t / TI, g.n2 - 1);
      const int i = min(i0 + t % TI, g.n1 - 1);
      cp_async<sizeof(T)>(rk + e, a.u1 + cidx(g, m, comp, 5, k, j, i));
    }
  };
  auto b_load = [&](int k) {
    for (int e = RU + tid; e < RU + 2 * (RB1 + RB2 + RB3); e += NT) {
      const int x = e - RU, half = RB1 + RB2 + RB3;
      const T* b1 = x < half ? a.b1 : a.b1o;
      const T* b2 = x < half ? a.b2 : a.b2o;
      const T* b3 = x < half ? a.b3 : a.b3o;
      const int h = x < half ? x : x - half;
      const T* src;
      if (h < RB1) {
        const int j = min(j0 + h / (TI + 1), g.n2 - 1);
        const int i = min(i0 + h % (TI + 1), g.n1);
        src = b1 + f1idx(g, m, k, j, i);
      } else if (h < RB1 + RB2) {
        const int v = h - RB1;
        const int j = min(j0 + v / TI, g.n2);
        const int i = min(i0 + v % TI, g.n1 - 1);
        src = b2 + f2idx(g, m, k, j, i);
      } else {
        const int v = h - RB1 - RB2;
        const int t = v % (TJ * TI);
        const int j = min(j0 + t / TI, g.n2 - 1);
        const int i = min(i0 + t % TI, g.n1 - 1);
        src = b3 + f3idx(g, m, k + v / (TJ * TI), j, i);
      }
      cp_async<sizeof(T)>(rk + e, src);
    }
  };

  // smem offsets by tile coordinates (jr, ir) = (j - j0, i - i0)
  auto at = [](TileRange r, int jr, int ir) {
    return (jr - r.j_lo) * r.ni + (ir - r.i_lo);
  };

  const T gam0 = static_cast<T>(cf.gam0), gam1 = static_cast<T>(cf.gam1);
  const T bdt = __ldg(static_cast<const T*>(cf.beta_dt));
  const T dx1 = static_cast<T>(cf.dx1), dx2 = static_cast<T>(cf.dx2),
          dx3 = static_cast<T>(cf.dx3);
  int fl[3] = {0, 0, 0};
  T dv[3] = {T(0), T(0), T(0)};

  // bcc + c2p of plane c over the prim range, from its stage slot, by
  // the threads first, first + stride, ...
  auto prim_plane = [&](int c, int first, int stride) {
    const T* st = stage + (c % 3) * L.stage_slot;
    const T* sb1 = st + 5 * HC;
    const T* sb2 = sb1 + HJ * (HI + 1);
    const T* sb3 = sb2 + (HJ + 1) * HI;
    T* pw = prim + (c & 3) * 8 * HC;
    T* pu = u0s + (c & 3) * 5 * TJ * TI;
    for (int h = first; h < HC; h += stride) {
      const int jj = h / HI, ii = h % HI;
      const T bx = T(0.5) * (sb1[jj * (HI + 1) + ii] +
                             sb1[jj * (HI + 1) + ii + 1]);
      const T by = T(0.5) * (sb2[h] + sb2[h + HI]);
      const T bz = T(0.5) * (sb3[h] + sb3[HC + h]);
      T uu[5], ww[5], uf[5];
      for (int q = 0; q < 5; ++q) uu[q] = st[q * HC + h];
      int fd, fe, ft;
      c2p(uu, bx, by, bz, eos, ww, uf, fd, fe, ft);
      for (int q = 0; q < 5; ++q) pw[q * HC + h] = ww[q];
      pw[5 * HC + h] = bx;
      pw[6 * HC + h] = by;
      pw[7 * HC + h] = bz;
      const int jr = jj + RP.j_lo, ir = ii + RP.i_lo;
      if (jr >= 0 && jr < TJ && ir >= 0 && ir < TI)
        for (int q = 0; q < 5; ++q) pu[q * TJ * TI + jr * TI + ir] = uf[q];
    }
  };

  // Step p computes the fluxes of plane p (B), the RK update of plane
  // k = p - 1 and the corner EMFs (C), then CT, c2p and the writes of
  // plane k (D).  The update leaves threads idle; they load u1 of plane
  // p and the raw plane p + 3 and compute the primitives of plane p + 2
  // (A), which the next step's fluxes read.  The prologue computes the
  // primitives of the first three planes.  Each step commits two groups
  // of copies in every thread: b and b_old of plane k (after the first
  // barrier), then u1 of plane p with the raw plane p + 3 (in D).
  const int ks0 = ks + PK0, last_plane = ke - 1 + PK1;
  constexpr int IDLE = TJ * TI;  // threads from here on are idle in D
  static_assert(NT > IDLE, "the update must leave threads to load with");
  for (int c = ks0; c < ks0 + 3; ++c) stage_load(c, tid, NT);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int c = ks0; c < ks0 + 3; ++c) prim_plane(c, tid, NT);
  __syncthreads();
  stage_load(ks0 + 3, tid, NT);  // into the slot of plane ks0
  cp_async_commit();
  for (int p = ks + FK0; p <= last_plane - 1; ++p) {
    __syncthreads();
    // b and b_old of plane k's faces; the slot's last reader was the
    // update of the step before, which the barrier above closed
    const int k = p - 1;
    const bool update = k >= ks && k < ke;
    if (update) b_load(k);
    cp_async_commit();

    // B. PLM + floors + HLLD: x1 and x2 faces of plane p, x3 faces of
    // face plane p, one work list
    {
      const bool inplane = p >= ks + FK0 && p <= ke - 1 + FK1;
      const bool normal = p >= ks + F3K0;
      const int nwork = (inplane ? N1F + N2F : 0) + (normal ? N3F : 0);
      for (int t = tid; t < nwork; t += NT) {
        int dir, jr, ir, o[4];  // o: the stencil cells in the prim ring
        T* out;
        int nout;
        const int w = inplane ? t : t + N1F + N2F;
        if (w < N1F) {
          dir = 0;
          jr = R1.j_lo + w / R1.ni;
          ir = R1.i_lo + w % R1.ni;
          out = f1 + (p & 1) * 7 * N1F + w;
          nout = N1F;
        } else if (w < N1F + N2F) {
          dir = 1;
          jr = R2.j_lo + (w - N1F) / R2.ni;
          ir = R2.i_lo + (w - N1F) % R2.ni;
          out = f2 + (p & 1) * 7 * N2F + (w - N1F);
          nout = N2F;
        } else {
          dir = 2;
          jr = R3.j_lo + (w - N1F - N2F) / R3.ni;
          ir = R3.i_lo + (w - N1F - N2F) % R3.ni;
          out = f3 + (p & 1) * 7 * N3F + (w - N1F - N2F);
          nout = N3F;
        }
        // the normal field from plane p's stage slot
        const int h = at(RP, jr, ir);
        const T* st = stage + (p % 3) * L.stage_slot + 5 * HC;
        T bx;
        if (dir == 0) {
          for (int s = 0; s < 4; ++s) o[s] = (p & 3) * 8 * HC + h + s - 2;
          bx = st[(jr - RP.j_lo) * (HI + 1) + ir - RP.i_lo];
        } else if (dir == 1) {
          for (int s = 0; s < 4; ++s)
            o[s] = (p & 3) * 8 * HC + h + (s - 2) * HI;
          bx = st[HJ * (HI + 1) + h];
        } else {
          for (int s = 0; s < 4; ++s) o[s] = ((p - 2 + s) & 3) * 8 * HC + h;
          bx = st[HJ * (HI + 1) + (HJ + 1) * HI + h];
        }
        // rotated frame: ivx normal, (ivy, ivz) transverse; B likewise
        const int ivx = dir + 1;
        const int ivy = (dir + 1) % 3 + 1;
        const int ivz = (dir + 2) % 3 + 1;
        const int iby = 5 + (dir + 1) % 3;
        const int ibz = 5 + (dir + 2) % 3;
        auto recon = [&](int comp, T& ql, T& qr) {
          const T* q = prim + comp * HC;
          plm_face(q[o[0]], q[o[1]], q[o[2]], q[o[3]], ql, qr);
        };
        FaceState<T> Lf, Rf;
        recon(0, Lf.d, Rf.d);
        recon(ivx, Lf.vx, Rf.vx);
        recon(ivy, Lf.vy, Rf.vy);
        recon(ivz, Lf.vz, Rf.vz);
        recon(4, Lf.e, Rf.e);
        recon(iby, Lf.by, Rf.by);
        recon(ibz, Lf.bz, Rf.bz);
        Lf.d = tmax(Lf.d, eos.dfloor);
        Rf.d = tmax(Rf.d, eos.dfloor);
        Lf.e = tmax(Lf.e, eos.efloor);
        Rf.e = tmax(Rf.e, eos.efloor);
        T fr[5], fby, fbz;
        hlld(Lf, Rf, bx, eos, fr, fby, fbz);
        // conserved order d, m1, m2, m3, E, then the face EMFs (ey, ez)
        out[0] = fr[0];
        out[ivx * nout] = fr[1];
        out[ivy * nout] = fr[2];
        out[ivz * nout] = fr[3];
        out[4 * nout] = fr[4];
        out[5 * nout] = -fby;
        out[6 * nout] = fbz;
      }
    }
    cp_async_wait<1>();  // u1 of plane k and the raw plane p + 2
    __syncthreads();

    // C. the RK update of plane k's cells (the flux divergence, into the
    // slot of their floored u), then the corner EMFs: e1, e2 on edge
    // plane p, e3 on plane p - 1
    {
      const int q = p - 1;
      const bool edges = p >= ks + EK0 && p <= ke - 1 + kEdgeK12.hi;
      const bool plane = q >= ks + E3K0 && q <= ke - 1 + E3K1;
      const int nrk = update ? 5 * TJ * TI : 0;
      const int nwork =
          nrk + (edges ? NE1 + NE2 : 0) + (plane ? NE3 : 0);
      auto P = [&](int k, int comp, int jr, int ir) {
        return prim[((k & 3) * 8 + comp) * HC + at(RP, jr, ir)];
      };
      auto X1 = [&](int k, int comp, int jr, int ir) {
        return f1[((k & 1) * 7 + comp) * N1F + at(R1, jr, ir)];
      };
      auto X2 = [&](int k, int comp, int jr, int ir) {
        return f2[((k & 1) * 7 + comp) * N2F + at(R2, jr, ir)];
      };
      auto X3 = [&](int k, int comp, int jr, int ir) {
        return f3[((k & 1) * 7 + comp) * N3F + at(R3, jr, ir)];
      };
      // cell-centred EMFs E = -v x B
      auto e1cc = [&](int k, int jr, int ir) {
        return P(k, 3, jr, ir) * P(k, 6, jr, ir) -
               P(k, 2, jr, ir) * P(k, 7, jr, ir);
      };
      auto e2cc = [&](int k, int jr, int ir) {
        return P(k, 1, jr, ir) * P(k, 7, jr, ir) -
               P(k, 3, jr, ir) * P(k, 5, jr, ir);
      };
      auto e3cc = [&](int k, int jr, int ir) {
        return P(k, 2, jr, ir) * P(k, 5, jr, ir) -
               P(k, 1, jr, ir) * P(k, 6, jr, ir);
      };
      for (int t = tid; t < nwork; t += NT) {
        if (t < nrk) {  // component c of cell r
          const int c = t / (TJ * TI), r = t % (TJ * TI);
          const int jr = r / TI, ir = r % TI;
          const T* x1 = f1 + ((k & 1) * 7 + c) * N1F + at(R1, jr, ir);
          const T* x2 = f2 + ((k & 1) * 7 + c) * N2F + at(R2, jr, ir);
          const T* x3l = f3 + ((k & 1) * 7 + c) * N3F + at(R3, jr, ir);
          const T* x3r = f3 + (((k + 1) & 1) * 7 + c) * N3F + at(R3, jr, ir);
          T divf = (x1[1] - x1[0]) / dx1;
          divf = divf + (x2[R2.ni] - x2[0]) / dx2;
          divf = divf + (x3r[0] - x3l[0]) / dx3;
          T& u0 = u0s[(k & 3) * 5 * TJ * TI + t];
          u0 = gam0 * u0 + gam1 * rk[t] - bdt * divf;
          continue;
        }
        const int w = (edges ? t : t + NE1 + NE2) - nrk;
        const int kk = p;
        if (w < NE1) {
          // E1 along x1: a = x2 (x2 faces' ey), b = x3 (x3 faces' ez)
          const int jr = Q1.j_lo + w / Q1.ni, ir = Q1.i_lo + w % Q1.ni;
          e1[(p & 1) * NE1 + w] = gs07(
              e1cc(kk, jr, ir), e1cc(kk, jr - 1, ir), e1cc(kk - 1, jr, ir),
              e1cc(kk - 1, jr - 1, ir), X2(kk, 5, jr, ir),
              X2(kk - 1, 5, jr, ir), X3(kk, 6, jr, ir), X3(kk, 6, jr - 1, ir),
              X2(kk, 0, jr, ir), X2(kk - 1, 0, jr, ir), X3(kk, 0, jr, ir),
              X3(kk, 0, jr - 1, ir));
        } else if (w < NE1 + NE2) {
          // E2 along x2: a = x3 (x3 faces' ey), b = x1 (x1 faces' ez)
          const int v = w - NE1;
          const int jr = Q2.j_lo + v / Q2.ni, ir = Q2.i_lo + v % Q2.ni;
          e2[(p & 1) * NE2 + v] = gs07(
              e2cc(kk, jr, ir), e2cc(kk - 1, jr, ir), e2cc(kk, jr, ir - 1),
              e2cc(kk - 1, jr, ir - 1), X3(kk, 5, jr, ir),
              X3(kk, 5, jr, ir - 1), X1(kk, 6, jr, ir), X1(kk - 1, 6, jr, ir),
              X3(kk, 0, jr, ir), X3(kk, 0, jr, ir - 1), X1(kk, 0, jr, ir),
              X1(kk - 1, 0, jr, ir));
        } else {
          // E3 along x3 on plane q: a = x1 (x1 faces' ey), b = x2 (ez)
          const int v = w - NE1 - NE2;
          const int jr = Q3.j_lo + v / Q3.ni, ir = Q3.i_lo + v % Q3.ni;
          e3[v] = gs07(e3cc(q, jr, ir), e3cc(q, jr, ir - 1),
                       e3cc(q, jr - 1, ir), e3cc(q, jr - 1, ir - 1),
                       X1(q, 5, jr, ir), X1(q, 5, jr - 1, ir),
                       X2(q, 6, jr, ir), X2(q, 6, jr, ir - 1),
                       X1(q, 0, jr, ir), X1(q, 0, jr - 1, ir),
                       X2(q, 0, jr, ir), X2(q, 0, jr, ir - 1));
        }
      }
    }
    cp_async_wait<0>();  // b and b_old of plane k
    __syncthreads();

    // D. CT of plane k's faces, bcc and c2p of the new state, the writes
    // and the dt maxima; the threads this leaves idle load u1 of plane p
    // and the raw plane p + 3 (whose slot held plane p, last read by B)
    // and compute the primitives of plane p + 2 (A; their ring slot held
    // plane p - 2, last read by B)
    if (update) {
      for (int t = tid; t < TJ * TI; t += NT) {
        const int jr = t / TI, ir = t % TI;
        const int j = j0 + jr, i = i0 + ir;
        if (j >= box.j1 || i >= box.i1) continue;
        T un[5];
        for (int c = 0; c < 5; ++c)
          un[c] = u0s[((k & 3) * 5 + c) * TJ * TI + t];
        auto E1 = [&](int kk, int jq, int iq) {
          return e1[(kk & 1) * NE1 + at(Q1, jq, iq)];
        };
        auto E2 = [&](int kk, int jq, int iq) {
          return e2[(kk & 1) * NE2 + at(Q2, jq, iq)];
        };
        auto E3 = [&](int jq, int iq) { return e3[at(Q3, jq, iq)]; };
        // b and b_old of the cell's faces in the rk slot
        const T* rb1 = rk + RU + jr * (TI + 1);
        const T* rb2 = rk + RU + RB1 + ir;
        const T* rb3 = rk + RU + RB1 + RB2 + t;
        constexpr int OLD = RB1 + RB2 + RB3;
        auto face1 = [&](int iq) {
          T b = gam0 * rb1[iq] + gam1 * rb1[OLD + iq];
          b = b - bdt * ((E3(jr + 1, iq) - E3(jr, iq)) / dx2);
          b = b + bdt * ((E2(k + 1, jr, iq) - E2(k, jr, iq)) / dx3);
          return b;
        };
        auto face2 = [&](int jq) {
          T b = gam0 * rb2[jq * TI] + gam1 * rb2[OLD + jq * TI];
          b = b + bdt * ((E3(jq, ir + 1) - E3(jq, ir)) / dx1);
          b = b - bdt * ((E1(k + 1, jq, ir) - E1(k, jq, ir)) / dx3);
          return b;
        };
        auto face3 = [&](int kk) {
          const int o = (kk - k) * TJ * TI;
          T b = gam0 * rb3[o] + gam1 * rb3[OLD + o];
          b = b - bdt * ((E2(kk, jr, ir + 1) - E2(kk, jr, ir)) / dx1);
          b = b + bdt * ((E1(kk, jr + 1, ir) - E1(kk, jr, ir)) / dx2);
          return b;
        };
        const T b1l = face1(ir), b1r = face1(ir + 1);
        const T b2l = face2(jr), b2r = face2(jr + 1);
        const T b3l = face3(k), b3r = face3(k + 1);

        // output bcc + c2p with the floors
        const T bx = T(0.5) * (b1l + b1r);
        const T by = T(0.5) * (b2l + b2r);
        const T bz = T(0.5) * (b3l + b3r);
        T wn[5], uf[5];
        int f0, f1c, f2c;
        c2p(un, bx, by, bz, eos, wn, uf, f0, f1c, f2c);
        fl[0] += f0;
        fl[1] += f1c;
        fl[2] += f2c;
        for (int c = 0; c < 5; ++c) a.uo[cidx(g, m, c, 5, k, j, i)] = uf[c];
        a.b1n[f1idx(g, m, k, j, i)] = b1l;
        a.b2n[f2idx(g, m, k, j, i)] = b2l;
        a.b3n[f3idx(g, m, k, j, i)] = b3l;
        if (i == g.n1 - g.ng - 1) a.b1n[f1idx(g, m, k, j, i + 1)] = b1r;
        if (j == g.n2 - g.ng - 1) a.b2n[f2idx(g, m, k, j + 1, i)] = b2r;
        if (k == g.n3 - g.ng - 1) a.b3n[f3idx(g, m, k + 1, j, i)] = b3r;

        // new-dt signal speeds (physics/mhd.py new_dt)
        const T pg = eos.gm1 * wn[4];
        dv[0] = tmax(dv[0], fabs(wn[1]) + fast_speed(eos, wn[0], pg, bx, by,
                                                     bz));
        dv[1] = tmax(dv[1], fabs(wn[2]) + fast_speed(eos, wn[0], pg, by, bz,
                                                     bx));
        dv[2] = tmax(dv[2], fabs(wn[3]) + fast_speed(eos, wn[0], pg, bz, bx,
                                                     by));
      }
    }
    if (tid >= IDLE) {
      if (p >= ks && p < ke) u1_load(p, tid - IDLE, NT - IDLE);
      if (p + 3 <= last_plane) stage_load(p + 3, tid - IDLE, NT - IDLE);
    }
    cp_async_commit();
    if (tid >= IDLE && p + 2 <= last_plane)
      prim_plane(p + 2, tid - IDLE, NT - IDLE);
  }

  // the block's floor counts and maxima, one atomic per quantity
  block_sum_max<T, NT>(fl, dv, a.red);
}

template <typename T>
int launch(const StageArgs<T>& a, int nmb, int n3, int n2, int n1, int ng,
           Coef cf, Eos<T> eos, cudaStream_t s) {
  using S = StageTile<T>;
  auto kernel = stage_kernel<T, S::TJ, S::TI, S::NT, S::MINB>;
  const size_t smem =
      static_cast<size_t>(stage_smem(S::TJ, S::TI).total) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        S::NT, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const TileGeom geo = tile_geom(nmb, n3, n2, n1, ng, S::TJ, S::TI,
                                 static_cast<long long>(sms) * per_sm);
  Dims g{nmb, n3, n2, n1, ng, static_cast<long long>(n3) * n2 * n1};
  err = cudaMemsetAsync(a.red, 0, 6 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(geo.blocks), S::NT, smem, s>>>(
      a, g, eos, cf, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

#define ATHENAK_MEGA_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                       \
      const void* u, const void* b1, const void* b2, const void* b3,         \
      const void* u1, const void* b1o, const void* b2o, const void* b3o,     \
      void* uo, void* b1n, void* b2n, void* b3n, void* red, int nmb, int n3, \
      int n2, int n1, int ng, double gam0, double gam1,                      \
      const void* beta_dt,                                                   \
      double dx1, double dx2, double dx3, double gamma, double dfloor,       \
      double pfloor, double tfloor, double sfloor, double sigma_max,         \
      void* stream) {                                                        \
    using namespace athenak;                                                 \
    StageArgs<T> a{static_cast<const T*>(u),   static_cast<const T*>(b1),    \
                   static_cast<const T*>(b2),  static_cast<const T*>(b3),    \
                   static_cast<const T*>(u1),  static_cast<const T*>(b1o),   \
                   static_cast<const T*>(b2o), static_cast<const T*>(b3o),   \
                   static_cast<T*>(uo),        static_cast<T*>(b1n),         \
                   static_cast<T*>(b2n),       static_cast<T*>(b3n),         \
                   static_cast<unsigned long long*>(red)};                   \
    return launch<T>(                                                        \
        a, nmb, n3, n2, n1, ng, Coef{gam0, gam1, beta_dt, dx1, dx2, dx3},    \
        make_eos<T>(gamma, dfloor, pfloor, tfloor, sfloor, sigma_max),       \
        static_cast<cudaStream_t>(stream));                                  \
  }

ATHENAK_MEGA_ENTRY(athenak_mega_stage_v2_f32, float)
ATHENAK_MEGA_ENTRY(athenak_mega_stage_v2_f64, double)
