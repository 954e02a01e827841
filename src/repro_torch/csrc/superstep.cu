// The sim daemon's gated superstep for NVIDIA Hopper (sm_90a): two kernels
// around the burst kernel of fused_primitive.cu.
//
// They replace no TPU kernel.  The reference's superstep
// (src/repro/core/scheduler.py rank_superstep under vmap, and the body of
// src/repro/core/daemon.py _sim_body_fn) is jnp code that XLA fuses; the
// port ran it as about 620 small ATen kernels over [R, C] and [R, L] int
// and bool tables, and those launches were the superstep's whole cost.
// Here it is, per superstep:
//
//   occl_superstep_select    phase A (the inbox's counts, and its payload
//                            rows committed into their connector slots),
//                            phase B (the SQ fetch and its SUBMIT event),
//                            phase C up to the gate (lane keys, stable
//                            positions, thresholds, preempt rotation, queue
//                            front, burst quota); writes the BurstLanes
//   occl_fused_burst         unchanged (fused_primitive.cu)
//   occl_superstep_finish    the context advance, completion and chain
//                            advance, the CQ, the flight recorder, the
//                            per-rank counters, the ring exchange of
//                            counts, collective ids and payload rows, and
//                            the drained / quit / budget vote
//
// The state and the mailbox are updated IN PLACE; every write is gated on
// the rank's ``global_live`` as the superstep started (select copies it to
// ``live0`` before anything is written).  The result equals the plain body
// (core/daemon.py _sim_body_fn, the scheduler's PyTorch ops) bit for bit.
// The rules that keep it so:
//
// * int32 arithmetic wraps as PyTorch's does: sums, differences and
//   products run on unsigned values (signed overflow is undefined in C++);
//   ``%`` is the floor modulo of ``torch.remainder``.
// * A stable double argsort is a rank: the keys smaller than a key plus the
//   equal keys at a lower index; the queue front is the lowest key, ties to
//   the lowest index.
// * A dropped set (``_set_drop``) writes the SUM of the values aimed at a
//   target (an out-of-range target matches nothing); adds (``_add_drop``,
//   ``scatter_add``) add every duplicate.
// * The drained / quit vote reads every rank's state after its superstep.
//   ``global_live`` is one value on every rank (the vote writes one value,
//   the launch prologue and a capture's warm-up one value); a rank that did
//   not run its superstep votes with its state as it stands.
//
// What bounds it: latency.  The work is a few hundred integer operations
// over [R, C] tables (R = 4, C = 8-10 in the benchmark's cells) and two
// copies of R * L * B payload rows (128 KiB at those cells).  Design: one
// block per kernel does the control plane, one warp per rank (looping when
// R exceeds the warps), one thread per collective (looping over C in steps
// of 32), a rank's tables staged in shared memory and every reduction over
// collectives a warp reduction; no block-wide barrier but the vote's.  The
// payload rows are copied by the other blocks of the same launch, in
// 16-byte units where the rows allow: in select the commit reads
// ``head_mirror`` before its update, which finish writes (select hands the
// new mirrors over in ``mirrors``), so the commit needs no order against
// the control block; in finish the exchange copies the burst's outbox.
//
// Plain C interface (loaded with ctypes); each entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kI32Max = 0x7fffffff;
constexpr int kMaxWarps = 16;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kUnroll = 4;   // copy units a thread moves per tile

// Per-lane values select hands to finish: aux[k, r, l].
enum Aux {
  A_CAND, A_C, A_VALID, A_GATE, A_N, A_NRECV, A_NSEND, A_WANT, A_STALLED,
  A_DENIED, A_STEP_DONE, A_COLL_DONE, A_NEXT_STEP, A_NEXT_SLICE, A_NEXT_ROUND,
  A_CUR_C, A_OVER, kAux
};
// The BurstLanes int fields in lanes[k, r, l] (``write`` is its own bool).
enum LaneField { B_COLL, B_TAIL, B_RND, B_SL, B_CHUNK, B_PRIM, B_N, kLaneFields };

struct Args {
  // --- state (DaemonState), [R, ...] -----------------------------------
  int* head; int* tail_mirror; int* head_mirror; int* tail;
  char* payload;                 // [R, C, K, SL], rows of row_bytes
  unsigned char* tq_active; int* arrival; int* prio; int* cur;
  int* ctx_step; int* ctx_slice; int* ctx_round; int* spin; int* boost;
  int* in_off; int* out_off;
  const int* sq_coll; const int* sq_prio; const int* sq_in; const int* sq_out;
  const int* sq_size; int* sq_read;
  int* cq_coll; int* cq_count; unsigned char* inflight;
  int* completed; int* stage_completions; int* preempts; int* stall_slices;
  int* qlen_at_fetch;
  int* supersteps; int* launch_steps; int* no_prog;
  unsigned char* made_prog_prev; int* slices_moved; unsigned char* global_live;
  int* fetch_step; int* rtc_latency; int* rtc_events;
  int* fr_kind; int* fr_coll; int* fr_step; int* fr_count; int* fr_kinds;
  // --- mailbox in flight, [R, L, ...]; replaced by the exchange --------
  int* fwd_count; int* fwd_coll; char* fwd_payload; int* rev_count;
  int* rev_coll;
  // --- shared tables ---------------------------------------------------
  const unsigned char* registered; const int* lane; const int* lane_caps;
  const int* n_steps; const int* n_slices; const int* n_rounds;
  const int* base_in_off; const int* base_out_off; const int* next_coll;
  const int* chain_tail; const unsigned char* chain_prio_inherit;
  const unsigned char* chain_mask;
  const int* prim_recv; const int* prim_send; const int* prim_copy;
  // --- per-rank tables -------------------------------------------------
  const unsigned char* member; const int* prog_kind; const int* prog_chunk;
  const int* chain_next; const int* chain_tail_r;
  const long long* fwd_src; const long long* rev_src;   // [L, R]
  // --- scratch the wrapper allocates ----------------------------------
  int* lanes;                    // [kLaneFields, R, L]
  unsigned char* write;          // [R, L]
  int* aux;                      // [kAux, R, L]
  int* raux;                     // [3, R]: live0, fetched, moved_any
  int* mirrors;                  // [2, R, C]: new head_mirror, tail_mirror
  unsigned char* fired;          // [R, C] (chains only)
  const char* outbox;            // [R, L, B, SL] (finish)
  int* steps;                    // [] supersteps run (finish)
  // --- sizes and the configuration --------------------------------------
  int R, C, L, B, K, S, P, SQL, CQL, FR;
  int fr_on, prio_policy, prio_preempts, quantum, cap, stickiness, demand;
  int qcs, spin_base, spin_decr, spin_boost, spin_min, spin_max, quit;
  int budget, demand_stride, prio_stride, prim_null;
  int ev_submit, ev_stage_done, ev_preempt, ev_handoff, ev_cqe, n_kinds;
  int chains;
  long long row_bytes;           // one payload row (SL elements)
  int unit;                      // copy unit in bytes: 16, 8, 4, 2 or 1
  int warps;                     // control block's warps
};

constexpr int kPtrs = 79;
constexpr int kDims = 35;

// ---------------------------------------------------------------------------
// int32 arithmetic as PyTorch does it
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}
// Floor modulo for m > 0 (torch.remainder).
__device__ __forceinline__ int fmodi(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
__device__ __forceinline__ int warp_sum(int v) {
  return static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
}

// Shared ints of one warp's region: 20 [C] tables and 40 [L] lane values
// (select's 6 [L] arrays, finish's 27 and its 3 x 4L events).
__host__ __device__ __forceinline__ int warp_ints(int C, int L) {
  return 20 * C + 40 * L + 8;
}

// ---------------------------------------------------------------------------
// payload rows
// ---------------------------------------------------------------------------

template <typename U>
__device__ __forceinline__ void copy_tile(char* dst, const char* src,
                                          long long u0, long long u1) {
  U* d = reinterpret_cast<U*>(dst);
  const U* s = reinterpret_cast<const U*>(src);
  for (long long u = u0 + threadIdx.x; u < u1; u += blockDim.x) d[u] = s[u];
}

// Units [tile * T, ...) of one row, T = blockDim.x * kUnroll.
__device__ void copy_row_tile(const Args& a, char* dst, const char* src,
                              int tile) {
  const long long n = a.row_bytes / a.unit;
  const long long per = static_cast<long long>(blockDim.x) * kUnroll;
  const long long u0 = tile * per;
  const long long u1 = min(n, u0 + per);
  switch (a.unit) {
    case 16: copy_tile<uint4>(dst, src, u0, u1); break;
    case 8: copy_tile<uint2>(dst, src, u0, u1); break;
    case 4: copy_tile<unsigned>(dst, src, u0, u1); break;
    case 2: copy_tile<unsigned short>(dst, src, u0, u1); break;
    default: copy_tile<unsigned char>(dst, src, u0, u1); break;
  }
}

__device__ __forceinline__ int row_tiles(const Args& a) {
  const long long n = a.row_bytes / a.unit;
  const long long per = static_cast<long long>(blockDim.x) * kUnroll;
  return static_cast<int>((n + per - 1) / per);
}

// Phase A's payload: inbox row (r, l, b), b < count, into connector slot
// (head_mirror[r, c] + b) % K of c = fwd_coll[r, l] (head_mirror as the
// superstep found it).
__device__ void commit_tile(const Args& a, int id) {
  const int tiles = row_tiles(a);
  const int row = id / tiles;
  const int b = row % a.B;
  const int rl = row / a.B;
  const int r = rl / a.L;
  if (!a.global_live[r]) return;
  if (b >= clampi(a.fwd_count[rl], 0, a.B)) return;
  const int c = clampi(a.fwd_coll[rl], 0, a.C - 1);
  const int slot = fmodi(wadd(a.head_mirror[r * a.C + c], b), a.K);
  char* dst = a.payload
      + ((static_cast<long long>(r) * a.C + c) * a.K + slot) * a.row_bytes;
  copy_row_tile(a, dst, a.fwd_payload + row * a.row_bytes, id % tiles);
}

// The exchange's payload: receiver row (r, l, b) from the outbox of rank
// fwd_src[l, r] on lane l.
__device__ void exchange_tile(const Args& a, int id) {
  const int tiles = row_tiles(a);
  const int row = id / tiles;
  const int b = row % a.B;
  const int rl = row / a.B;
  const int l = rl % a.L;
  const int r = rl / a.L;
  if (!a.raux[r]) return;
  const int src = static_cast<int>(a.fwd_src[l * a.R + r]);
  const long long srow = (static_cast<long long>(src) * a.L + l) * a.B + b;
  copy_row_tile(a, a.fwd_payload + row * a.row_bytes,
                a.outbox + srow * a.row_bytes, id % tiles);
}

// ---------------------------------------------------------------------------
// the flight recorder
// ---------------------------------------------------------------------------

// Append E masked events of rank r to its ring (scheduler._record_events):
// slots by the exclusive count of the valid events before each, all but
// the newest FR of them dropped; fr_kinds counts every valid event.
__device__ void record(const Args& a, int r, int E, const int* kinds,
                       const int* colls, const int* valid, int sup, int t) {
  const int FR = a.FR;
  int mine = 0;
  for (int e = t; e < E; e += 32) mine += valid[e];
  const int total = warp_sum(mine);
  const int frc = a.fr_count[r];
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + t;
    const bool v = e < E && valid[e];
    const unsigned bal = __ballot_sync(kFull, v);
    const int off = base + __popc(bal & ((1u << t) - 1u));
    if (v && off >= total - FR) {
      const int s = r * FR + fmodi(wadd(frc, off), FR);
      a.fr_kind[s] = kinds[e];
      a.fr_coll[s] = colls[e];
      a.fr_step[s] = sup;
    }
    base += __popc(bal);
  }
  for (int k = t; k < a.n_kinds; k += 32) {
    int n = 0;
    for (int e = 0; e < E; ++e) n += valid[e] && kinds[e] == k;
    if (n) a.fr_kinds[r * a.n_kinds + k] = wadd(a.fr_kinds[r * a.n_kinds + k], n);
  }
  __syncwarp();
  if (t == 0) a.fr_count[r] = wadd(frc, total);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// select
// ---------------------------------------------------------------------------

struct Tables {                  // one warp's [C] working copies
  int *tq, *inf, *memb, *lane, *arr, *prio, *ep, *key, *cstep, *cslice;
  int *cround, *spin, *boost, *inoff, *outoff, *head, *tail, *hm, *tm;
  int *fetch;
};

__device__ __forceinline__ Tables tables_at(int* w, int C) {
  Tables s;
  s.tq = w; s.inf = w + C; s.memb = w + 2 * C; s.lane = w + 3 * C;
  s.arr = w + 4 * C; s.prio = w + 5 * C; s.ep = w + 6 * C; s.key = w + 7 * C;
  s.cstep = w + 8 * C; s.cslice = w + 9 * C; s.cround = w + 10 * C;
  s.spin = w + 11 * C; s.boost = w + 12 * C; s.inoff = w + 13 * C;
  s.outoff = w + 14 * C; s.head = w + 15 * C; s.tail = w + 16 * C;
  s.hm = w + 17 * C; s.tm = w + 18 * C; s.fetch = w + 19 * C;
  return s;
}

// Effective priority and queue key of every collective of the warp's rank
// (scheduler._effective_prio, _lane_keys before the lane mask).
__device__ void queue_keys(const Args& a, const Tables& s, int lsteps, int t) {
  for (int c = t; c < a.C; c += 32) {
    int ep = s.prio[c];
    if (a.quantum > 0) {
      const int age = max(wsub(wadd(a.C, lsteps), s.arr[c]), 0);
      ep = clampi(wadd(ep, min(age / a.quantum, a.cap)), -512, 512);
    }
    int key = s.arr[c];
    if (a.demand) key = wsub(key, wmul(s.tail[c] < s.hm[c] ? 1 : 0, a.demand_stride));
    if (a.prio_policy) key = wadd(wmul(wsub(0, ep), a.prio_stride), key);
    s.ep[c] = ep;
    s.key[c] = key;
  }
  __syncwarp();
}

__device__ __forceinline__ bool eligible(const Tables& s, int c, int l) {
  return s.tq[c] && s.memb[c] && s.lane[c] == l;
}

__device__ void select_rank(const Args& a, int r, int t, int* w) {
  const int C = a.C, L = a.L, RL = a.R * a.L, rc0 = r * C;
  const bool live = a.global_live[r] != 0;
  if (t == 0) a.raux[r] = live;
  if (!live) {                   // nothing of the rank is written
    for (int l = t; l < L; l += 32) {
      for (int k = 0; k < kLaneFields; ++k) a.lanes[k * RL + r * L + l] = 0;
      for (int k = 0; k < kAux; ++k) a.aux[k * RL + r * L + l] = 0;
      a.write[r * L + l] = 0;
    }
    if (t == 0) a.raux[a.R + r] = a.raux[2 * a.R + r] = 0;
    return;
  }
  const Tables s = tables_at(w, C);
  int* l_cur = w + 20 * C;
  int* l_curc = l_cur + L;
  int* l_ok = l_curc + L;
  int* l_over = l_ok + L;
  int* l_front = l_over + L;
  int* l_nel = l_front + L;
  int* ev = l_nel + L;           // one SUBMIT event: kind, coll, valid

  // Phase A: the inbox's counts (the payload is the other blocks').
  for (int c = t; c < C; c += 32) {
    const int i = rc0 + c;
    s.tq[c] = a.tq_active[i];
    s.inf[c] = a.inflight[i];
    s.memb[c] = a.member[i];
    s.lane[c] = a.lane[c];
    s.arr[c] = a.arrival[i];
    s.prio[c] = a.prio[i];
    s.cstep[c] = a.ctx_step[i];
    s.cslice[c] = a.ctx_slice[i];
    s.cround[c] = a.ctx_round[i];
    s.spin[c] = a.spin[i];
    s.boost[c] = a.boost[i];
    s.inoff[c] = a.in_off[i];
    s.outoff[c] = a.out_off[i];
    s.head[c] = a.head[i];
    s.tail[c] = a.tail[i];
    s.fetch[c] = a.fetch_step[i];
    int hm = a.head_mirror[i], tm = a.tail_mirror[i];
    for (int l = 0; l < L; ++l) {
      const int rl = r * L + l;
      if (clampi(a.fwd_coll[rl], 0, C - 1) == c)
        hm = wadd(hm, clampi(a.fwd_count[rl], 0, a.B));
      if (clampi(a.rev_coll[rl], 0, C - 1) == c)
        tm = wadd(tm, max(a.rev_count[rl], 0));
    }
    s.hm[c] = hm;
    s.tm[c] = tm;
    a.mirrors[i] = hm;
    a.mirrors[a.R * C + i] = tm;
  }
  __syncwarp();

  // Phase B: at most one SQE into the task queue.
  const int sup = a.supersteps[r], lsteps = a.launch_steps[r];
  int mine = 0;
  for (int c = t; c < C; c += 32) mine += s.tq[c];
  const int qlen = warp_sum(mine);
  const int sq_read = a.sq_read[r];
  const bool has = sq_read < a.sq_size[r];
  const bool want = a.prio_policy ? has
                                  : has && (!a.made_prog_prev[r] || qlen == 0);
  const int slot = r * a.SQL + clampi(sq_read, 0, a.SQL - 1);
  const int c_raw = a.sq_coll[slot];
  const int cc = clampi(c_raw, 0, C - 1);
  const bool ok = want && c_raw >= 0 && !s.inf[cc] && s.memb[cc]
      && a.registered[cc];
  __syncwarp();                  // every thread has read what ok writes
  if (ok) {
    const int sq_out = a.sq_out[slot], sq_in = a.sq_in[slot];
    const int tl = a.chain_tail_r[rc0 + cc];
    const bool ovr = sq_out >= 0 && tl == a.chain_tail[cc];
    const int resolved = ovr ? sq_out : a.base_out_off[clampi(tl, 0, C - 1)];
    for (int c = t; c < C; c += 32) {
      if (c == tl) s.outoff[c] = resolved;
      if (c == cc && tl != cc) s.outoff[c] = a.base_out_off[cc];
      if (c == cc) {
        s.tq[c] = 1;
        s.arr[c] = wadd(C, lsteps);
        s.prio[c] = clampi(a.sq_prio[slot], -512, 512);
        s.inoff[c] = sq_in >= 0 ? sq_in : a.base_in_off[cc];
        s.cstep[c] = s.cslice[c] = s.cround[c] = s.spin[c] = s.boost[c] = 0;
        a.qlen_at_fetch[rc0 + c] = qlen;
        s.fetch[c] = sup;
      }
      if (a.chain_mask[cc * C + c]) s.inf[c] = 1;
    }
  }
  if (t == 0) {
    a.sq_read[r] = wadd(sq_read, ok ? 1 : 0);
    ev[0] = a.ev_submit;
    ev[1] = c_raw;
    ev[2] = ok;
  }
  __syncwarp();
  if (a.fr_on) record(a, r, 1, ev, ev + 1, ev + 2, sup, t);

  // Phase C: each lane's current collective, overspun or not.
  queue_keys(a, s, lsteps, t);
  for (int l = 0; l < L; ++l) {
    const int cur = a.cur[r * L + l];
    const int cur_c = clampi(cur, 0, C - 1);
    const bool el_cur = eligible(s, cur_c, l);
    const int kc = el_cur ? s.key[cur_c] : kI32Max;
    const int ep_cur = s.ep[cur_c];
    int before = 0;
    bool higher = false;
    for (int c = t; c < C; c += 32) {
      const bool el = eligible(s, c, l);
      const int k = el ? s.key[c] : kI32Max;
      before += k < kc || (k == kc && c < cur_c);
      higher = higher || (el && s.ep[c] > ep_cur);
    }
    const int pos = warp_sum(before);
    const bool any_higher = __any_sync(kFull, higher);
    const int thr = a.stickiness
        ? clampi(wadd(wsub(a.spin_base, wmul(pos, a.spin_decr)), s.boost[cur_c]),
                 a.spin_min, a.spin_max)
        : clampi(a.spin_base, a.spin_min, a.spin_max);
    const bool cur_ok = cur >= 0 && el_cur;
    bool over = cur_ok && s.spin[cur_c] > thr;
    if (a.prio_preempts) over = over || (cur_ok && any_higher);
    if (t == 0) {
      l_cur[l] = cur;
      l_curc[l] = cur_c;
      l_ok[l] = cur_ok;
      l_over[l] = over;
    }
  }
  __syncwarp();

  // Preempt: the overspun collective to the back of its queue.
  for (int c = t; c < C; c += 32) {
    bool rot = false;
    for (int l = 0; l < L; ++l) rot = rot || (l_over[l] && l_curc[l] == c);
    if (rot) {
      a.preempts[rc0 + c] = wadd(a.preempts[rc0 + c], 1);
      s.arr[c] = wadd(wadd(C, lsteps), 1);
      s.spin[c] = 0;
      s.boost[c] = 0;
    }
  }
  __syncwarp();

  // Queue front after the rotation (only ``arrival`` changed).
  queue_keys(a, s, lsteps, t);
  for (int l = 0; l < L; ++l) {
    int best_k = kI32Max, best_c = kI32Max, n_el = 0;
    for (int c = t; c < C; c += 32) {
      const bool el = eligible(s, c, l);
      const int k = el ? s.key[c] : kI32Max;
      if (k < best_k || (k == best_k && c < best_c)) {
        best_k = k;
        best_c = c;
      }
      n_el += el;
    }
    const int mk = __reduce_min_sync(kFull, best_k);
    const int front = __reduce_min_sync(kFull, best_k == mk ? best_c : kI32Max);
    const int nel = warp_sum(n_el);
    if (t == 0) {
      l_front[l] = front;
      l_nel[l] = nel;
    }
  }
  __syncwarp();

  // The gate of each lane's burst, and what finish needs of it.
  bool moved = false;
  for (int l = t; l < L; l += 32) {
    const int rl = r * L + l;
    const bool keep = l_ok[l] && !l_over[l];
    const int cand = keep ? l_cur[l] : (l_nel[l] > 0 ? l_front[l] : -1);
    const int c = clampi(cand, 0, C - 1);
    const bool valid = cand >= 0;
    const int cstep = s.cstep[c];
    const int pk = (rc0 + c) * a.S + clampi(cstep, 0, a.S - 1);
    const int prim = a.prog_kind[pk];
    const int pi = clampi(prim, 0, a.P - 1);
    const bool nrecv = a.prim_recv[pi] > 0;
    const bool nsend = a.prim_send[pi] > 0;
    const int sl = s.cslice[c];
    const int nsl = a.n_slices[c];
    const int bl = a.lane_caps[l];
    const int room = wsub(nsl, sl);
    int q = min(bl, room);
    if (nrecv) q = min(q, wsub(s.hm[c], s.tail[c]));
    if (nsend) q = min(q, wsub(a.K, wsub(s.head[c], s.tm[c])));
    q = max(q, 0);
    const bool gate = valid && prim != a.prim_null && q > 0;
    const int n = gate ? q : 0;
    const int want_n = min(bl, max(room, 1));
    const int denied = max(wsub(want_n, n), 1);
    const int stalled = a.qcs && l_nel[l] <= 1 ? 1 : denied;
    const int rnd = s.cround[c];
    a.lanes[B_COLL * RL + rl] = c;
    a.lanes[B_TAIL * RL + rl] = s.tail[c];
    a.lanes[B_RND * RL + rl] = rnd;
    a.lanes[B_SL * RL + rl] = sl;
    a.lanes[B_CHUNK * RL + rl] = a.prog_chunk[pk];
    a.lanes[B_PRIM * RL + rl] = prim;
    a.lanes[B_N * RL + rl] = n;
    a.write[rl] = gate && a.prim_copy[pi] > 0;
    // The dynamic context's advance (round, primitive, slice).
    const int new_slice = wadd(sl, n);
    const bool step_done = gate && new_slice >= nsl;
    const bool seq_done = step_done && wadd(cstep, 1) >= a.n_steps[c];
    const int next_round = seq_done ? wadd(rnd, 1) : rnd;
    const int vals[kAux] = {
        cand, c, valid, gate, n, gate && nrecv ? n : 0, gate && nsend ? n : 0,
        want_n, stalled, denied, step_done,
        seq_done && next_round >= a.n_rounds[c],
        seq_done ? 0 : (step_done ? wadd(cstep, 1) : cstep),
        step_done ? 0 : new_slice, next_round, l_curc[l], l_over[l]};
#pragma unroll
    for (int k = 0; k < kAux; ++k) a.aux[k * RL + rl] = vals[k];
    moved = moved || gate;
  }
  moved = __any_sync(kFull, moved);
  if (t == 0) {
    a.raux[a.R + r] = ok;
    a.raux[2 * a.R + r] = moved;
  }

  // What select changed, back to the state.
  for (int c = t; c < C; c += 32) {
    const int i = rc0 + c;
    a.tq_active[i] = s.tq[c] != 0;
    a.inflight[i] = s.inf[c] != 0;
    a.arrival[i] = s.arr[c];
    a.prio[i] = s.prio[c];
    a.ctx_step[i] = s.cstep[c];
    a.ctx_slice[i] = s.cslice[c];
    a.ctx_round[i] = s.cround[c];
    a.spin[i] = s.spin[c];
    a.boost[i] = s.boost[c];
    a.in_off[i] = s.inoff[c];
    a.out_off[i] = s.outoff[c];
    a.fetch_step[i] = s.fetch[c];
  }
}

__global__ void superstep_select_kernel(Args a) {
  if (blockIdx.x > 0) {
    commit_tile(a, blockIdx.x - 1);
    return;
  }
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  int* w = smem + warp * warp_ints(a.C, a.L);
  for (int r = warp; r < a.R; r += a.warps) {
    select_rank(a, r, t, w);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// finish
// ---------------------------------------------------------------------------

struct Vote {
  int drained;                   // every rank drained (AND)
  int min_no_prog;
  int ls0;                       // launch_steps of rank 0
};

// The rank's share of the vote, from its state as it now stands.
__device__ void vote(const Args& a, int r, int t, int no_prog, int ls,
                     Vote* v) {
  bool busy = false;
  for (int c = t; c < a.C; c += 32) {
    busy = busy || a.tq_active[r * a.C + c] || a.inflight[r * a.C + c];
  }
  busy = __any_sync(kFull, busy);
  if (t == 0) {
    atomicAnd(&v->drained, a.sq_read[r] >= a.sq_size[r] && !busy ? 1 : 0);
    atomicMin(&v->min_no_prog, no_prog);
    if (r == 0) v->ls0 = ls;
  }
}

__device__ void finish_rank(const Args& a, int r, int t, int* w, Vote* v) {
  const int C = a.C, L = a.L, RL = a.R * a.L, rc0 = r * C;
  if (!a.raux[r]) {              // nothing of the rank is written
    if (a.chains) {
      for (int c = t; c < C; c += 32) a.fired[rc0 + c] = 0;
    }
    vote(a, r, t, a.no_prog[r], a.launch_steps[r], v);
    return;
  }
  int* la[kAux];
#pragma unroll
  for (int k = 0; k < kAux; ++k) la[k] = w + k * L;
  int* x = w + kAux * L;
  int* x_adv = x;
  int* x_ldone = x + L;
  int* x_cd = x + 2 * L;
  int* x_sc = x + 3 * L;
  int* x_scmid = x + 4 * L;
  int* x_sprio = x + 5 * L;
  int* x_fetch = x + 6 * L;
  int* x_spin = x + 7 * L;
  int* x_cq = x + 8 * L;
  int* x_in = x + 9 * L;
  int* ek = x + 10 * L;          // events: 4L kinds, colls, valid
  int* ec = ek + 4 * L;
  int* evv = ec + 4 * L;

  // Per lane: completion, chain successor, and the values read at its c.
  for (int l = t; l < L; l += 32) {
    const int rl = r * L + l;
#pragma unroll
    for (int k = 0; k < kAux; ++k) la[k][l] = a.aux[k * RL + rl];
    const int c = la[A_C][l];
    const int succ = a.chain_next[rc0 + c];
    const int succ_c = clampi(succ, 0, C - 1);
    const bool done = la[A_COLL_DONE][l];
    const bool adv = done && succ >= 0;
    x_adv[l] = adv;
    x_ldone[l] = done && succ < 0;
    x_cd[l] = done ? c : C;
    x_sc[l] = adv ? succ_c : C;
    x_scmid[l] = adv && a.chain_next[rc0 + succ_c] >= 0 ? succ_c : C;
    x_sprio[l] = a.chain_prio_inherit[succ_c] ? a.prio[rc0 + c] : 0;
    x_fetch[l] = a.fetch_step[rc0 + c];
    x_spin[l] = a.spin[rc0 + c];
    x_in[l] = a.base_in_off[succ_c];
  }
  __syncwarp();
  if (t == 0) {
    int before = 0;
    const int cqc = a.cq_count[r];
    for (int l = 0; l < L; ++l) {
      x_cq[l] = x_ldone[l] ? fmodi(wadd(cqc, before), a.CQL) : a.CQL;
      before = wadd(before, x_ldone[l]);
    }
  }
  __syncwarp();

  const int sup = a.supersteps[r], ls = a.launch_steps[r];
  bool busy = false;
  for (int c = t; c < C; c += 32) {
    const int i = rc0 + c;
    // The context advance ...
    int tail = a.tail[i], head = a.head[i], boost = a.boost[i];
    int cstep = a.ctx_step[i], cslice = a.ctx_slice[i], cround = a.ctx_round[i];
    int spin = a.spin[i], stall = a.stall_slices[i];
    bool m_cg = false, m_cv = false;
    int s_step = 0, s_slice = 0, s_round = 0, s_spin = 0;
    for (int l = 0; l < L; ++l) {
      if (la[A_C][l] != c) continue;
      const bool gate = la[A_GATE][l];
      tail = wadd(tail, la[A_NRECV][l]);
      head = wadd(head, la[A_NSEND][l]);
      if (la[A_STEP_DONE][l] && !la[A_COLL_DONE][l] && a.stickiness)
        boost = wadd(boost, a.spin_boost);
      if (gate) {
        m_cg = true;
        s_step = wadd(s_step, la[A_NEXT_STEP][l]);
        s_slice = wadd(s_slice, la[A_NEXT_SLICE][l]);
        s_round = wadd(s_round, la[A_NEXT_ROUND][l]);
      }
      if (la[A_VALID][l]) {
        m_cv = true;
        s_spin = wadd(s_spin, gate ? 0 : wadd(x_spin[l], la[A_STALLED][l]));
        stall = wadd(stall, gate ? max(wsub(la[A_WANT][l], la[A_N][l]), 0)
                                 : la[A_DENIED][l]);
      }
    }
    if (m_cg) {
      cstep = s_step;
      cslice = s_slice;
      cround = s_round;
    }
    if (m_cv) spin = s_spin;
    // ... then completion and the chain advance on top of it.
    bool tq = a.tq_active[i], inf = a.inflight[i];
    const int stagec0 = a.stage_completions[i];
    int completed = a.completed[i], stagec = stagec0;
    int rtc_lat = a.rtc_latency[i], rtc_ev = a.rtc_events[i];
    int fetch = a.fetch_step[i], arr = a.arrival[i], prio = a.prio[i];
    int inoff = a.in_off[i], outoff = a.out_off[i];
    bool m_cd = false, m_sc = false, m_mid = false, clear = false;
    int s_fetch = 0, s_arr = 0, s_prio = 0, s_in = 0, s_out = 0;
    for (int l = 0; l < L; ++l) {
      if (la[A_C][l] == c) {
        completed = wadd(completed, x_ldone[l]);
        stagec = wadd(stagec, la[A_COLL_DONE][l]);
      }
      if (x_cd[l] == c) {
        m_cd = true;
        rtc_lat = wadd(rtc_lat, wsub(sup, x_fetch[l]));
        rtc_ev = wadd(rtc_ev, 1);
      }
      if (x_sc[l] == c) {
        m_sc = true;
        s_fetch = wadd(s_fetch, sup);
        s_arr = wadd(s_arr, wadd(wadd(C, 1), ls));
        s_prio = wadd(s_prio, x_sprio[l]);
        s_in = wadd(s_in, x_in[l]);
      }
      if (x_scmid[l] == c) {
        m_mid = true;
        s_out = wadd(s_out, a.base_out_off[x_scmid[l]]);
      }
      if (x_ldone[l] && a.chain_mask[la[A_C][l] * C + c]) clear = true;
    }
    if (m_cd) tq = false;
    if (m_sc) {
      tq = true;
      fetch = s_fetch;
      arr = s_arr;
      prio = s_prio;
      cstep = cslice = cround = spin = boost = 0;
      inoff = s_in;
    }
    if (m_mid) outoff = s_out;
    inf = inf && !clear;
    a.tail[i] = tail;
    a.head[i] = head;
    a.ctx_step[i] = cstep;
    a.ctx_slice[i] = cslice;
    a.ctx_round[i] = cround;
    a.spin[i] = spin;
    a.boost[i] = boost;
    a.stall_slices[i] = stall;
    a.tq_active[i] = tq;
    a.inflight[i] = inf;
    a.completed[i] = completed;
    a.stage_completions[i] = stagec;
    a.rtc_latency[i] = rtc_lat;
    a.rtc_events[i] = rtc_ev;
    a.fetch_step[i] = fetch;
    a.arrival[i] = arr;
    a.prio[i] = prio;
    a.in_off[i] = inoff;
    a.out_off[i] = outoff;
    a.head_mirror[i] = a.mirrors[i];
    a.tail_mirror[i] = a.mirrors[a.R * C + i];
    if (a.chains) {
      a.fired[i] = stagec > stagec0 && a.chain_next[i] == a.next_coll[c]
          && a.next_coll[c] >= 0;
    }
    busy = busy || tq || inf;
  }

  // The CQ, each lane's current collective, the exchange's counts.
  for (int j = t; j < a.CQL; j += 32) {
    bool m = false;
    int sum = 0;
    for (int l = 0; l < L; ++l) {
      if (x_cq[l] == j) {
        m = true;
        sum = wadd(sum, la[A_C][l]);
      }
    }
    if (m) a.cq_coll[r * a.CQL + j] = sum;
  }
  int moved_n = 0, done_n = 0;
  for (int l = 0; l < L; ++l) {
    moved_n = wadd(moved_n, la[A_N][l]);
    done_n = wadd(done_n, x_ldone[l]);
  }
  for (int l = t; l < L; l += 32) {
    const int rl = r * L + l;
    a.cur[rl] = la[A_COLL_DONE][l] || !la[A_VALID][l] ? -1 : la[A_CAND][l];
    const int fs = static_cast<int>(a.fwd_src[l * a.R + r]) * L + l;
    const int rs = static_cast<int>(a.rev_src[l * a.R + r]) * L + l;
    a.fwd_count[rl] = a.aux[A_NSEND * RL + fs];
    a.fwd_coll[rl] = a.aux[A_C * RL + fs];
    a.rev_count[rl] = a.aux[A_NRECV * RL + rs];
    a.rev_coll[rl] = a.aux[A_C * RL + rs];
  }

  // The flight recorder: this superstep's lane transitions.
  if (a.fr_on) {
    for (int e = t; e < 4 * L; e += 32) {
      const int g = e / L, l = e % L;
      ek[e] = g == 0 ? a.ev_preempt : g == 1 ? a.ev_stage_done
            : g == 2 ? a.ev_handoff : a.ev_cqe;
      ec[e] = g == 0 ? la[A_CUR_C][l] : la[A_C][l];
      evv[e] = g == 0 ? la[A_OVER][l] : g == 1 ? la[A_COLL_DONE][l]
             : g == 2 ? x_adv[l] : x_ldone[l];
    }
    __syncwarp();
    record(a, r, 4 * L, ek, ec, evv, sup, t);
  }

  // The rank's clocks and progress; its share of the vote.
  const bool moved = a.raux[2 * a.R + r] != 0;
  const bool progress = moved || a.raux[a.R + r] != 0;
  const int no_prog = progress ? 0 : wadd(a.no_prog[r], 1);
  busy = __any_sync(kFull, busy);
  if (t == 0) {
    a.slices_moved[r] = wadd(a.slices_moved[r], moved_n);
    a.cq_count[r] = wadd(a.cq_count[r], done_n);
    a.supersteps[r] = wadd(sup, 1);
    a.launch_steps[r] = wadd(ls, 1);
    a.no_prog[r] = no_prog;
    a.made_prog_prev[r] = moved;
    atomicAnd(&v->drained, a.sq_read[r] >= a.sq_size[r] && !busy ? 1 : 0);
    atomicMin(&v->min_no_prog, no_prog);
    if (r == 0) v->ls0 = wadd(ls, 1);
  }
}

__global__ void superstep_finish_kernel(Args a) {
  if (blockIdx.x > 0) {
    exchange_tile(a, blockIdx.x - 1);
    return;
  }
  extern __shared__ int smem[];
  __shared__ Vote v;
  if (threadIdx.x == 0) {
    v.drained = 1;
    v.min_no_prog = kI32Max;
    v.ls0 = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  int* w = smem + warp * warp_ints(a.C, a.L);
  for (int r = warp; r < a.R; r += a.warps) {
    finish_rank(a, r, t, w, &v);
    __syncwarp();
  }
  __syncthreads();
  const bool still = !(v.drained || v.min_no_prog >= a.quit
                       || v.ls0 >= a.budget);
  for (int r = threadIdx.x; r < a.R; r += blockDim.x) {
    if (a.raux[r]) a.global_live[r] = still;
  }
  if (threadIdx.x == 0) a.steps[0] = wadd(a.steps[0], a.raux[0] ? 1 : 0);
}

bool unpack(Args& a, void* const* p, int n_ptrs, const int* d, int n_dims,
            long long row_bytes, int unit) {
  if (n_ptrs != kPtrs || n_dims != kDims) return false;
  int i = 0;
  auto I = [&]() { return static_cast<int*>(p[i++]); };
  auto U = [&]() { return static_cast<unsigned char*>(p[i++]); };
  auto X = [&]() { return static_cast<char*>(p[i++]); };
  a.head = I(); a.tail_mirror = I(); a.head_mirror = I(); a.tail = I();
  a.payload = X();
  a.tq_active = U(); a.arrival = I(); a.prio = I(); a.cur = I();
  a.ctx_step = I(); a.ctx_slice = I(); a.ctx_round = I(); a.spin = I();
  a.boost = I(); a.in_off = I(); a.out_off = I();
  a.sq_coll = I(); a.sq_prio = I(); a.sq_in = I(); a.sq_out = I();
  a.sq_size = I(); a.sq_read = I();
  a.cq_coll = I(); a.cq_count = I(); a.inflight = U();
  a.completed = I(); a.stage_completions = I(); a.preempts = I();
  a.stall_slices = I(); a.qlen_at_fetch = I();
  a.supersteps = I(); a.launch_steps = I(); a.no_prog = I();
  a.made_prog_prev = U(); a.slices_moved = I(); a.global_live = U();
  a.fetch_step = I(); a.rtc_latency = I(); a.rtc_events = I();
  a.fr_kind = I(); a.fr_coll = I(); a.fr_step = I(); a.fr_count = I();
  a.fr_kinds = I();
  a.fwd_count = I(); a.fwd_coll = I(); a.fwd_payload = X();
  a.rev_count = I(); a.rev_coll = I();
  a.registered = U(); a.lane = I(); a.lane_caps = I(); a.n_steps = I();
  a.n_slices = I(); a.n_rounds = I(); a.base_in_off = I();
  a.base_out_off = I(); a.next_coll = I(); a.chain_tail = I();
  a.chain_prio_inherit = U(); a.chain_mask = U();
  a.prim_recv = I(); a.prim_send = I(); a.prim_copy = I();
  a.member = U(); a.prog_kind = I(); a.prog_chunk = I();
  a.chain_next = I(); a.chain_tail_r = I();
  a.fwd_src = static_cast<const long long*>(p[i++]);
  a.rev_src = static_cast<const long long*>(p[i++]);
  a.lanes = I(); a.write = U(); a.aux = I(); a.raux = I(); a.mirrors = I();
  a.fired = U(); a.outbox = X(); a.steps = I();
  if (i != kPtrs) return false;
  int j = 0;
  a.R = d[j++]; a.C = d[j++]; a.L = d[j++]; a.B = d[j++]; a.K = d[j++];
  a.S = d[j++]; a.P = d[j++]; a.SQL = d[j++]; a.CQL = d[j++]; a.FR = d[j++];
  a.fr_on = d[j++]; a.prio_policy = d[j++]; a.prio_preempts = d[j++];
  a.quantum = d[j++]; a.cap = d[j++]; a.stickiness = d[j++];
  a.demand = d[j++]; a.qcs = d[j++];
  a.spin_base = d[j++]; a.spin_decr = d[j++]; a.spin_boost = d[j++];
  a.spin_min = d[j++]; a.spin_max = d[j++]; a.quit = d[j++];
  a.budget = d[j++]; a.demand_stride = d[j++]; a.prio_stride = d[j++];
  a.prim_null = d[j++];
  a.ev_submit = d[j++]; a.ev_stage_done = d[j++]; a.ev_preempt = d[j++];
  a.ev_handoff = d[j++]; a.ev_cqe = d[j++]; a.n_kinds = d[j++];
  a.chains = d[j++];
  if (j != kDims) return false;
  a.row_bytes = row_bytes;
  a.unit = unit;
  if (a.R < 1 || a.C < 1 || a.L < 1 || a.B < 1 || a.K < 1 || a.S < 1
      || a.P < 1 || a.SQL < 1 || a.CQL < 1 || a.FR < 1 || row_bytes < 1
      || row_bytes % unit != 0) {
    return false;
  }
  // The control block: one warp per rank up to kMaxWarps, as many as the
  // ranks' shared tables leave room for.
  const long long per = static_cast<long long>(warp_ints(a.C, a.L)) * 4;
  int warps = min(a.R, kMaxWarps);
  while (warps > 1 && per * warps > kSmemBytes) --warps;
  if (per * warps > kSmemBytes) return false;
  a.warps = warps;
  return true;
}

int launch(bool select, void* const* ptrs, int n_ptrs, const int* dims,
           int n_dims, long long row_bytes, int unit, void* stream) {
  Args a;
  if (!unpack(a, ptrs, n_ptrs, dims, n_dims, row_bytes, unit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 32 * a.warps;
  const long long per = static_cast<long long>(threads) * kUnroll;
  const long long tiles = (row_bytes / unit + per - 1) / per;
  const long long grid = 1 + static_cast<long long>(a.R) * a.L * a.B * tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warp_ints(a.C, a.L)) * 4 * a.warps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (select) {
    superstep_select_kernel<<<static_cast<unsigned>(grid), threads, smem, st>>>(a);
  } else {
    superstep_finish_kernel<<<static_cast<unsigned>(grid), threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``ptrs``: the 79 pointers in the order of Args (state, mailbox, shared
// tables, per-rank tables, fwd_src / rev_src, scratch); ``dims``: the 35
// sizes and configuration values in the order of Args; ``row_bytes``: one
// payload row; ``unit``: the payload copy unit in bytes (it divides
// row_bytes and the payload pointers' alignment).  The wrapper checks
// shapes, dtypes, devices and contiguity.
extern "C" int occl_superstep_select(void* const* ptrs, int n_ptrs,
                                     const int* dims, int n_dims,
                                     long long row_bytes, int unit,
                                     void* stream) {
  return launch(true, ptrs, n_ptrs, dims, n_dims, row_bytes, unit, stream);
}

extern "C" int occl_superstep_finish(void* const* ptrs, int n_ptrs,
                                     const int* dims, int n_dims,
                                     long long row_bytes, int unit,
                                     void* stream) {
  return launch(false, ptrs, n_ptrs, dims, n_dims, row_bytes, unit, stream);
}
