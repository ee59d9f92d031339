// Kernel E: one RK stage of 3-D Newtonian ideal MHD from primitives.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_mega_stage3d (the v1
// stage): from the ghost-filled primitives w and cell-centred field bcc,
// the face fields bfc, the RK base u0 and the register (u1, bfc_old), PLM
// + face-state floors + HLLD in x1/x2/x3, the flux-divergence update
// gam0*u0 + gam1*u1 - beta_dt*div(F), Gardiner-Stone 2007 corner EMFs and
// constrained transport on the three face fields.  No c2p, no counters,
// no dt: kernel F (fused_aux.cu) does those after the face fill.  Plain
// version: ops/stage_v1.py::fused_mega_stage3d_plain.
//
// What bounds it on the H100: arithmetic and its latency, as kernel A.
// The stage must move 32 values a cell (w, bcc, bfc, u0, u1, bfc_old in;
// u', bfc' out; 24 with gam1 = 0), 0.088 ms at 128^3 in float32; HLLD is
// some 250 flops and a dozen IEEE divisions and square roots a face,
// three faces a cell.  The first design took five launches (fluxes of
// each direction, edges, update) chained through 24 scratch values a
// cell in device memory.
//
// This design is one launch, kernel A's march (mega_stage_v2.cu) without
// its two c2p passes: a CUDA block owns a tile of TJ x TI interior
// columns of one MeshBlock and a segment of planes along k
// (stage_tile.cuh: the cut, the halos, stage_v1_smem), and marches
// through its planes with w, bcc, the fluxes and the EMFs in shared
// memory.  w and bcc (a ring of five planes), the normal field of each
// face (three planes) and u0, u1 are copied by cp.async one or more
// steps ahead of use.  At step p it
//   B. runs PLM + floors + HLLD once for each of the tile's x1 and x2
//      faces of plane p and x3 faces of face plane p, plus the row or
//      column the corner EMFs reach (one work list);
//   C. adds the flux divergence to u0 of plane k = p-1 (one item a cell
//      and component) and computes the GS07 corner EMFs e1, e2 of edge
//      plane p and e3 of plane p-1;
//   D. on one thread a cell of plane k: CT of the cell's faces, the
//      writes of u' and of the cell's lower faces (plus the upper face
//      on the last interior cell).  The other threads copy w and bcc of
//      plane p+3, the normal field of plane p+2 and u0, u1 of plane p.
// Every copy takes its address from a table of offsets in a plane that
// the block computes once (stage_v1_smem's `tables`); computing each
// copy's clamped index in place instead took 0.875 ms a call at 128^3
// against 0.669 with the tables, on an H100 80GB HBM3 at 700 W (PERF.md).
// With gam1 == 0 (the first stage of rk2/rk3) u1 and bfc_old are not
// read (the OLD = false instance), as the Pallas kernel's skip_old
// drops them; the update is then gam0*u0 - beta_dt*div(F), the first
// design's expression.  The numerics are the first design's, term by
// term and in the same order (hlld.cuh, plm_face, the face floors,
// gs07, the update's divergence x1, x2, x3 and the CT's terms), so its
// results are bitwise equal.
//
// Ghost cells and faces of the outputs are left as they are; the fills
// write them.

#include "async_copy.cuh"
#include "mhd_stage.cuh"
#include "stage_tile.cuh"

namespace athenak {
namespace {

template <typename T>
struct StageV1Args {
  const T *w, *bcc, *b1, *b2, *b3, *u0, *u1, *b1o, *b2o, *b3o;
  T *uo, *b1n, *b2n, *b3n;
};

template <typename T, int TJ, int TI, int NT, int MINB, bool OLD>
__global__ void __launch_bounds__(NT, MINB)
    stage_v1_kernel(StageV1Args<T> a, Dims g, Eos<T> eos, Coef cf,
                    TileGeom geo) {
  constexpr StageV1Smem L = stage_v1_smem(TJ, TI);
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
  constexpr int NC = TJ * TI;
  // the march below keeps rings of 5 primitive planes, 3 normal-field
  // planes and 2 flux and edge planes, which these k ranges need
  constexpr int PK0 = kPrimK.lo, PK1 = kPrimK.hi;
  constexpr int FK0 = kFluxK12.lo, FK1 = kFluxK12.hi, F3K0 = kFluxK3.lo;
  constexpr int EK0 = kEdgeK12.lo, E3K0 = kEdgeK3.lo, E3K1 = kEdgeK3.hi;
  static_assert(PK0 == -2 && PK1 == 2 && FK0 == -1 && FK1 == 1 &&
                    F3K0 == 0 && kFluxK3.hi == 1 && EK0 == 0 &&
                    kEdgeK12.hi == 1 && E3K0 == 0 && E3K1 == 0,
                "the rings of the march assume these k ranges");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const prim = sm + L.prim;  // [5][8][HC]
  T* const nf = sm + L.nf;      // [3][N1F + N2F + N3F]
  T* const f1 = sm + L.f1;      // [2][7][N1F]
  T* const f2 = sm + L.f2;      // [2][7][N2F]
  T* const f3 = sm + L.f3;      // [2][7][N3F]
  T* const e1 = sm + L.e1;      // [2][NE1]
  T* const e2 = sm + L.e2;      // [2][NE2]
  T* const e3 = sm + L.e3;      // [NE3]
  T* const u0s = sm + L.u0;     // [2][5][NC]
  T* const u1s = sm + L.u1;     // [5][NC]
  T* const rk = sm + L.rk;      // b, b_old of the tile's faces

  const TileBox box = tile_box(geo, blockIdx.x);
  const int m = box.m, ks = box.k0, ke = box.k1;
  const int j0 = box.j0, i0 = box.i0;
  const int tid = threadIdx.x;

  // What the copies read, as offsets in a plane, computed once a block
  // (reads outside the array, a ragged tile's halo, are clamped): tprim
  // the prim range's cells, tnf the normal field of phase B's work list,
  // tu the tile's cells, tb the faces of the rk slot.
  constexpr int NF = N1F + N2F + N3F;
  constexpr int RB1 = TJ * (TI + 1), RB2 = (TJ + 1) * TI, RB3 = 2 * NC;
  constexpr int RB = RB1 + RB2 + RB3;
  static_assert(L.tables == HC + NF + NC + RB, "the offset tables");
  __shared__ int tables[L.tables];
  int* const tprim = tables;
  int* const tnf = tprim + HC;
  int* const tu = tnf + NF;
  int* const tb = tu + NC;
  const int n1 = g.n1, n2 = g.n2, plane = n2 * n1;
  for (int h = tid; h < HC; h += NT)
    tprim[h] = clampi(j0 + RP.j_lo + h / HI, 0, n2 - 1) * n1 +
               clampi(i0 + RP.i_lo + h % HI, 0, n1 - 1);
  for (int e = tid; e < NF; e += NT) {
    if (e < N1F) {
      tnf[e] = clampi(j0 + R1.j_lo + e / R1.ni, 0, n2 - 1) * (n1 + 1) +
               clampi(i0 + R1.i_lo + e % R1.ni, 0, n1);
    } else if (e < N1F + N2F) {
      const int v = e - N1F;
      tnf[e] = clampi(j0 + R2.j_lo + v / R2.ni, 0, n2) * n1 +
               clampi(i0 + R2.i_lo + v % R2.ni, 0, n1 - 1);
    } else {
      const int v = e - N1F - N2F;
      tnf[e] = clampi(j0 + R3.j_lo + v / R3.ni, 0, n2 - 1) * n1 +
               clampi(i0 + R3.i_lo + v % R3.ni, 0, n1 - 1);
    }
  }
  for (int t = tid; t < NC; t += NT)
    tu[t] = min(j0 + t / TI, n2 - 1) * n1 + min(i0 + t % TI, n1 - 1);
  for (int h = tid; h < RB; h += NT) {
    if (h < RB1) {
      tb[h] = min(j0 + h / (TI + 1), n2 - 1) * (n1 + 1) +
              min(i0 + h % (TI + 1), n1);
    } else if (h < RB1 + RB2) {
      const int v = h - RB1;
      tb[h] = min(j0 + v / TI, n2) * n1 + min(i0 + v % TI, n1 - 1);
    } else {
      const int v = h - RB1 - RB2, t = v % NC;
      tb[h] = (v / NC) * plane + min(j0 + t / TI, n2 - 1) * n1 +
              min(i0 + t % TI, n1 - 1);
    }
  }
  // the first plane of MeshBlock m's channel 0 of a cell array with nc
  // channels, and plane c of its face arrays
  auto cells = [&](const T* arr, int nc, int c) {
    return arr + (static_cast<long long>(m) * nc * g.n3 + c) * plane;
  };
  auto faces1 = [&](const T* arr, int c) {
    return arr + (static_cast<long long>(m) * g.n3 + c) * n2 * (n1 + 1);
  };
  auto faces2 = [&](const T* arr, int c) {
    return arr + (static_cast<long long>(m) * g.n3 + c) * (n2 + 1) * n1;
  };
  auto faces3 = [&](const T* arr, int c) {
    return arr + (static_cast<long long>(m) * (g.n3 + 1) + c) * plane;
  };

  // w and bcc of plane c over the prim range into its ring slot
  auto prim_load = [&](int c, int first, int stride) {
    T* dst = prim + (c % 5) * 8 * HC;
    const T* ws = cells(a.w, 5, c);
    const T* bs = cells(a.bcc, 3, c);
    for (int h = first; h < HC; h += stride) {
      const int o = tprim[h];
      for (int q = 0; q < 5; ++q)
        cp_async<sizeof(T)>(dst + q * HC + h, ws + q * g.ncell + o);
      for (int q = 0; q < 3; ++q)
        cp_async<sizeof(T)>(dst + (5 + q) * HC + h, bs + q * g.ncell + o);
    }
  };
  // the normal field of plane c's x1 and x2 faces and of face plane c's
  // x3 faces, in the order of phase B's work list
  auto nf_load = [&](int c, int first, int stride) {
    T* dst = nf + (c % 3) * L.nf_slot;
    const T* s1 = faces1(a.b1, c);
    const T* s2 = faces2(a.b2, c);
    const T* s3 = faces3(a.b3, c);
    for (int e = first; e < NF; e += stride)
      cp_async<sizeof(T)>(dst + e,
                          (e < N1F ? s1 : e < N1F + N2F ? s2 : s3) + tnf[e]);
  };
  // u0 (and u1) of the tile's cells of plane k
  auto u_load = [&](int k, int first, int stride) {
    const T* s0 = cells(a.u0, 5, k);
    for (int t = first; t < NC; t += stride) {
      const int o = tu[t];
      for (int q = 0; q < 5; ++q)
        cp_async<sizeof(T)>(u0s + ((k & 1) * 5 + q) * NC + t,
                            s0 + q * g.ncell + o);
      if constexpr (OLD) {
        const T* s1 = cells(a.u1, 5, k);
        for (int q = 0; q < 5; ++q)
          cp_async<sizeof(T)>(u1s + q * NC + t, s1 + q * g.ncell + o);
      }
    }
  };
  // b (and the RK register b_old) of the faces of plane k's cells
  auto b_load = [&](int k) {
    for (int e = tid; e < (OLD ? 2 : 1) * RB; e += NT) {
      const bool cur = e < RB;
      const int h = cur ? e : e - RB;
      const T* src = h < RB1 ? faces1(cur ? a.b1 : a.b1o, k)
                     : h < RB1 + RB2 ? faces2(cur ? a.b2 : a.b2o, k)
                                     : faces3(cur ? a.b3 : a.b3o, k);
      cp_async<sizeof(T)>(rk + e, src + tb[h]);
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

  // Step p computes the fluxes of plane p (B), the RK update of plane
  // k = p - 1 and the corner EMFs (C), then the CT and the writes of
  // plane k (D).  Copies: the prologue brings w and bcc of planes
  // ks - 2 .. ks + 1 and the normal field of planes ks - 1 and ks; each
  // step commits two groups of copies in every thread: b and b_old of
  // plane k (first, waited for before D), then, on the threads D leaves
  // idle, w and bcc of plane p + 3, the normal field of plane p + 2 and
  // u0, u1 of plane p (waited for after B of step p + 1).
  const int ks0 = ks + PK0, last_plane = ke - 1 + PK1;
  constexpr int IDLE = NC;  // threads from here on are idle in D
  static_assert(NT > IDLE, "the CT must leave threads to copy with");
  __syncthreads();  // the offset tables
  for (int c = ks0; c < ks0 + 4; ++c) prim_load(c, tid, NT);
  nf_load(ks + FK0, tid, NT);
  nf_load(ks, tid, NT);
  cp_async_commit();
  cp_async_wait<0>();
  for (int p = ks + FK0; p <= last_plane - 1; ++p) {
    __syncthreads();
    // b and b_old of plane k's faces; the slot's last reader was D of
    // the step before, which the barrier above closed
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
        const int h = at(RP, jr, ir);
        if (dir == 0) {
          for (int s = 0; s < 4; ++s) o[s] = (p % 5) * 8 * HC + h + s - 2;
        } else if (dir == 1) {
          for (int s = 0; s < 4; ++s)
            o[s] = (p % 5) * 8 * HC + h + (s - 2) * HI;
        } else {
          for (int s = 0; s < 4; ++s) o[s] = ((p - 2 + s) % 5) * 8 * HC + h;
        }
        const T bx = nf[(p % 3) * L.nf_slot + w];
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
    cp_async_wait<1>();  // u0, u1 of plane k, w and bcc of plane p + 2
    __syncthreads();

    // C. the RK update of plane k's cells (the flux divergence, into the
    // slot of their u0), then the corner EMFs: e1, e2 on edge plane p, e3
    // on plane p - 1
    {
      const int q = p - 1;
      const bool edges = p >= ks + EK0 && p <= ke - 1 + kEdgeK12.hi;
      const bool plane = q >= ks + E3K0 && q <= ke - 1 + E3K1;
      const int nrk = update ? 5 * NC : 0;
      const int nwork = nrk + (edges ? NE1 + NE2 : 0) + (plane ? NE3 : 0);
      auto P = [&](int kk, int comp, int jr, int ir) {
        return prim[((kk % 5) * 8 + comp) * HC + at(RP, jr, ir)];
      };
      auto X1 = [&](int kk, int comp, int jr, int ir) {
        return f1[((kk & 1) * 7 + comp) * N1F + at(R1, jr, ir)];
      };
      auto X2 = [&](int kk, int comp, int jr, int ir) {
        return f2[((kk & 1) * 7 + comp) * N2F + at(R2, jr, ir)];
      };
      auto X3 = [&](int kk, int comp, int jr, int ir) {
        return f3[((kk & 1) * 7 + comp) * N3F + at(R3, jr, ir)];
      };
      // cell-centred EMFs E = -v x B
      auto e1cc = [&](int kk, int jr, int ir) {
        return P(kk, 3, jr, ir) * P(kk, 6, jr, ir) -
               P(kk, 2, jr, ir) * P(kk, 7, jr, ir);
      };
      auto e2cc = [&](int kk, int jr, int ir) {
        return P(kk, 1, jr, ir) * P(kk, 7, jr, ir) -
               P(kk, 3, jr, ir) * P(kk, 5, jr, ir);
      };
      auto e3cc = [&](int kk, int jr, int ir) {
        return P(kk, 2, jr, ir) * P(kk, 5, jr, ir) -
               P(kk, 1, jr, ir) * P(kk, 6, jr, ir);
      };
      for (int t = tid; t < nwork; t += NT) {
        if (t < nrk) {  // component c of cell r
          const int c = t / NC, r = t % NC;
          const int jr = r / TI, ir = r % TI;
          const T* x1 = f1 + ((k & 1) * 7 + c) * N1F + at(R1, jr, ir);
          const T* x2 = f2 + ((k & 1) * 7 + c) * N2F + at(R2, jr, ir);
          const T* x3l = f3 + ((k & 1) * 7 + c) * N3F + at(R3, jr, ir);
          const T* x3r = f3 + (((k + 1) & 1) * 7 + c) * N3F + at(R3, jr, ir);
          T divf = (x1[1] - x1[0]) / dx1;
          divf = divf + (x2[R2.ni] - x2[0]) / dx2;
          divf = divf + (x3r[0] - x3l[0]) / dx3;
          T& u = u0s[(k & 1) * 5 * NC + t];
          if constexpr (OLD)
            u = gam0 * u + gam1 * u1s[t] - bdt * divf;
          else
            u = gam0 * u - bdt * divf;
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

    // D. CT of plane k's faces and the writes; the threads this leaves
    // idle copy w and bcc of plane p + 3 (into the ring slot of plane
    // p - 2, last read by B), the normal field of plane p + 2 (the slot
    // of plane p - 1) and u0, u1 of plane p (the u0 slot of plane p - 2,
    // last read by D of the step before; u1 of plane k, read by C)
    if (update) {
      for (int t = tid; t < NC; t += NT) {
        const int jr = t / TI, ir = t % TI;
        const int j = j0 + jr, i = i0 + ir;
        if (j >= box.j1 || i >= box.i1) continue;
        auto E1 = [&](int kk, int jq, int iq) {
          return e1[(kk & 1) * NE1 + at(Q1, jq, iq)];
        };
        auto E2 = [&](int kk, int jq, int iq) {
          return e2[(kk & 1) * NE2 + at(Q2, jq, iq)];
        };
        auto E3 = [&](int jq, int iq) { return e3[at(Q3, jq, iq)]; };
        // b and b_old of the cell's faces in the rk slot
        const T* rb1 = rk + jr * (TI + 1);
        const T* rb2 = rk + RB1 + ir;
        const T* rb3 = rk + RB1 + RB2 + t;
        auto base = [&](const T* b, int o) {
          if constexpr (OLD)
            return gam0 * b[o] + gam1 * b[RB + o];
          else
            return gam0 * b[o];
        };
        auto face1 = [&](int iq) {
          T b = base(rb1, iq);
          b = b - bdt * ((E3(jr + 1, iq) - E3(jr, iq)) / dx2);
          b = b + bdt * ((E2(k + 1, jr, iq) - E2(k, jr, iq)) / dx3);
          return b;
        };
        auto face2 = [&](int jq) {
          T b = base(rb2, jq * TI);
          b = b + bdt * ((E3(jq, ir + 1) - E3(jq, ir)) / dx1);
          b = b - bdt * ((E1(k + 1, jq, ir) - E1(k, jq, ir)) / dx3);
          return b;
        };
        auto face3 = [&](int kk) {
          T b = base(rb3, (kk - k) * NC);
          b = b - bdt * ((E2(kk, jr, ir + 1) - E2(kk, jr, ir)) / dx1);
          b = b + bdt * ((E1(kk, jr + 1, ir) - E1(kk, jr, ir)) / dx2);
          return b;
        };
        for (int c = 0; c < 5; ++c)
          a.uo[cidx(g, m, c, 5, k, j, i)] = u0s[((k & 1) * 5 + c) * NC + t];
        a.b1n[f1idx(g, m, k, j, i)] = face1(ir);
        a.b2n[f2idx(g, m, k, j, i)] = face2(jr);
        a.b3n[f3idx(g, m, k, j, i)] = face3(k);
        if (i == g.n1 - g.ng - 1)
          a.b1n[f1idx(g, m, k, j, i + 1)] = face1(ir + 1);
        if (j == g.n2 - g.ng - 1)
          a.b2n[f2idx(g, m, k, j + 1, i)] = face2(jr + 1);
        if (k == g.n3 - g.ng - 1)
          a.b3n[f3idx(g, m, k + 1, j, i)] = face3(k + 1);
      }
    }
    if (tid >= IDLE) {
      if (p + 3 <= last_plane) prim_load(p + 3, tid - IDLE, NT - IDLE);
      if (p + 2 <= ke) nf_load(p + 2, tid - IDLE, NT - IDLE);
      if (p >= ks && p < ke) u_load(p, tid - IDLE, NT - IDLE);
    }
    cp_async_commit();
  }
}

template <typename T, bool OLD>
int launch_instance(const StageV1Args<T>& a, int nmb, int n3, int n2,
                    int n1, int ng, Coef cf, Eos<T> eos, cudaStream_t s) {
  using S = StageTile<T>;
  auto kernel = stage_v1_kernel<T, S::TJ, S::TI, S::NT, S::MINB, OLD>;
  const size_t smem =
      static_cast<size_t>(stage_v1_smem(S::TJ, S::TI).total) * sizeof(T);
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
  kernel<<<static_cast<unsigned int>(geo.blocks), S::NT, smem, s>>>(
      a, g, eos, cf, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const StageV1Args<T>& a, int nmb, int n3, int n2, int n1, int ng,
           int skip_old, Coef cf, Eos<T> eos, cudaStream_t s) {
  return skip_old
             ? launch_instance<T, false>(a, nmb, n3, n2, n1, ng, cf, eos, s)
             : launch_instance<T, true>(a, nmb, n3, n2, n1, ng, cf, eos, s);
}

}  // namespace
}  // namespace athenak

#define ATHENAK_MEGA_V1_ENTRY(NAME, T)                                        \
  extern "C" int NAME(                                                        \
      const void* w, const void* bcc, const void* b1, const void* b2,         \
      const void* b3, const void* u0, const void* u1, const void* b1o,        \
      const void* b2o, const void* b3o, void* uo, void* b1n, void* b2n,       \
      void* b3n, int nmb, int n3, int n2, int n1, int ng, int skip_old,       \
      double gam0, double gam1, const void* beta_dt, double dx1, double dx2,  \
      double dx3, double gamma, double dfloor, double pfloor, double tfloor,  \
      double sfloor, double sigma_max, void* stream) {                        \
    using namespace athenak;                                                  \
    StageV1Args<T> a{                                                         \
        static_cast<const T*>(w),   static_cast<const T*>(bcc),               \
        static_cast<const T*>(b1),  static_cast<const T*>(b2),                \
        static_cast<const T*>(b3),  static_cast<const T*>(u0),                \
        static_cast<const T*>(u1),  static_cast<const T*>(b1o),               \
        static_cast<const T*>(b2o), static_cast<const T*>(b3o),               \
        static_cast<T*>(uo),        static_cast<T*>(b1n),                     \
        static_cast<T*>(b2n),       static_cast<T*>(b3n)};                    \
    return launch<T>(                                                         \
        a, nmb, n3, n2, n1, ng, skip_old,                                     \
        Coef{gam0, gam1, beta_dt, dx1, dx2, dx3},                             \
        make_eos<T>(gamma, dfloor, pfloor, tfloor, sfloor, sigma_max),        \
        static_cast<cudaStream_t>(stream));                                   \
  }

ATHENAK_MEGA_V1_ENTRY(athenak_mega_stage_v1_f32, float)
ATHENAK_MEGA_V1_ENTRY(athenak_mega_stage_v1_f64, double)
