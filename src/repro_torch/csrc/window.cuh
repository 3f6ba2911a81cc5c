// The card's send window: src/repro/core/schedule.py::SendWindow for the
// port's cooperative kernels (ring_attention.cu, kv_shuttle.cu,
// moe_dispatch.cu, gemm_allgather.cu).
//
// A Pallas kernel keeps at most `contexts` rounds' DMAs unretired: a round
// is issued, the kernel goes on, and the oldest round's send semaphore is
// waited only when a new round would pass the cap, and at the drain
// points. Here a round is the stores of one (edge, tile) of one CTA, and
// the mechanism is (a) of the two a Hopper card offers: TMA bulk stores.
// The payload of a round is staged in shared memory (a slot the kernel
// gives), and one thread of the CTA, the window's owner (thread 0), sends
// it with cp.async.bulk.global.shared::cta.bulk_group, one bulk group a
// piece (a slot's worth); a round of several pieces, or of several stores
// (a K / V pair, int8 data and its scale), is one window entry. The owner
// then goes on at once. Before a slot is written again it waits only until
// the bulk stores have READ it (cp.async.bulk.wait_group.read), never until
// they have landed, and it waits as late as it can (after the next
// piece's loads are issued), so the CTA stages and computes the next round
// while earlier ones are still on their way to device memory.
//
// Retiring the oldest round waits until its bulk groups have completed
// (cp.async.bulk.wait_group N, N the groups committed since its last
// piece), makes the async proxy's writes visible to the generic proxy
// (fence.proxy.async.global), fences, and only then releases the round's
// flag words (the kernel's `release`: atomicAdd of what landed), so a
// receiver's acquire load never sees a flag before the data. Rounds retire
// oldest first; push() retires before the new round is recorded; drain()
// retires everything, at the kernel's drain points.
//
// wait_group takes an immediate: the pending count goes through a switch
// of 0..15 (a round of many pieces under cap 4 can leave more than 15
// younger groups; waiting for 15 is then stronger than needed, never
// weaker). The kernel is not instantiated per cap: only this wait is.
//
// Shapes whose rows are not 16-byte multiples (f32 with a width not a
// multiple of 4) cannot be sent by bulk stores: there a kernel stores the
// round with plain stores as before and pushes it all the same. Its flag
// is released at retirement, after a fence of the owner: the window is
// then only the release order, since that fence also lands the younger
// rounds' stores.
//
// The probe build (-DCUCO_PROBE) has each CTA append its window events to
// a device log the wrapper sizes: push (edge, tile), retire, receive wait,
// drain, and marks, each with the low 32 bits of %globaltimer. A CTA's
// count runs on past its log's capacity, and the decoder
// (kernels/window.py) refuses a log whose count exceeds it: an overflow is
// never silent. The production build compiles no log code.
//
// The counting build (-DCUCO_STATS, cta_stats.cuh) adds the cycles the
// owner spends in bulk-group waits (retirement, a slot's read) to the
// counter its window was opened with; other builds compile no counting.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "flags.cuh"

namespace win {

constexpr int MAXCAP = 4;  // contexts is 1, 2 or 4 (core/design_space.py::CONTEXTS)

// log event kinds, as kernels/window.py decodes them
enum : int { EV_PUSH = 1, EV_RETIRE = 2, EV_RECV = 3, EV_MARK = 4, EV_DRAIN = 5 };
// marks (EV_MARK's first field), as kernels/window.py names them
enum : int { MARK_DISPATCH_ISSUED = 0, MARK_SHARED_FFN = 1, MARK_DISPATCH_DRAINED = 2 };

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// generic-proxy writes to shared memory, before the async proxy reads them
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst`, both
// 16-byte aligned; completes in the issuing thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every bulk group of this thread has read its shared-memory source (the
// owner, before its CTA writes a slot again)
__device__ __forceinline__ void wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the same, its cycles added to *wait in a counting build (-DCUCO_STATS,
// cta_stats.cuh) when wait is set
__device__ __forceinline__ void wait_read_all(unsigned long long* wait) {
#ifdef CUCO_STATS
  const long long c0 = wait ? clock64() : 0;
  wait_read_all();
  if (wait) *wait += clock64() - c0;
#else
  (void)wait;
  wait_read_all();
#endif
}

#define WIN_WAIT(N)                                                 \
  case N:                                                           \
    asm volatile("cp.async.bulk.wait_group " #N ";\n" ::: "memory"); \
    break;

// at most `pending` of this thread's bulk groups still in flight
__device__ __forceinline__ void wait_landed(unsigned pending) {
  switch (pending) {
    WIN_WAIT(0) WIN_WAIT(1) WIN_WAIT(2) WIN_WAIT(3) WIN_WAIT(4) WIN_WAIT(5) WIN_WAIT(6)
    WIN_WAIT(7) WIN_WAIT(8) WIN_WAIT(9) WIN_WAIT(10) WIN_WAIT(11) WIN_WAIT(12) WIN_WAIT(13)
    WIN_WAIT(14)
    default:
      asm volatile("cp.async.bulk.wait_group 15;\n" ::: "memory");
  }
}
#undef WIN_WAIT

// ------------------------------------------------------------ probe log

struct Log {
  int* base;  // (cap, 4) int32 events of this CTA
  int* n;     // events appended (may run past cap)
  int cap;
};

// the CTA's log in the launch's (grid, cap, 4) log and (grid) counts
__device__ __forceinline__ Log cta_log(int* log, int* log_n, int cap) {
  return Log{log + (size_t)blockIdx.x * cap * 4, log_n + blockIdx.x, cap};
}

// append an event (any thread; a no-op outside the probe build)
__device__ __forceinline__ void note(const Log& lg, int kind, int a, int b) {
#ifdef CUCO_PROBE
  const int i = atomicAdd(lg.n, 1);
  if (i < lg.cap)
    *reinterpret_cast<int4*>(lg.base + 4 * (size_t)i) =
        make_int4(kind, a, b, (int)(unsigned)globaltimer());
#else
  (void)lg, (void)kind, (void)a, (void)b;
#endif
}

// ------------------------------------------------------------ the window

// a round that releases one flag word by `amount`
struct Tick {
  unsigned* flag;
  unsigned amount;
};

__device__ __forceinline__ void release_tick(const Tick& t) {
  if (t.amount) atomicAdd(t.flag, t.amount);
}

// The window's state, in shared memory; only its owner (thread 0) touches
// it. R is the kernel's description of what a round releases.
template <class R>
struct Window {
  int cap, head, count;
  unsigned groups;          // bulk groups the owner has committed
  unsigned last[MAXCAP];    // `groups` after each unretired round's last piece
  R round[MAXCAP];
  Log log;
#ifdef CUCO_STATS
  unsigned long long* wait;  // the owner's bulk-group waits, counted (or null)
#endif
};

template <class R>
__device__ __forceinline__ void open(Window<R>& w, int contexts, const Log& lg,
                                     unsigned long long* wait = nullptr) {
  w.cap = contexts < 1 ? 1 : (contexts > MAXCAP ? MAXCAP : contexts);
  w.head = w.count = 0;
  w.groups = 0;
  w.log = lg;
#ifdef CUCO_STATS
  w.wait = wait;
#else
  (void)wait;
#endif
}

// the oldest round's bulk stores have landed: fence, then release its flags
template <class R, class Release>
__device__ __forceinline__ void retire_oldest(Window<R>& w, Release&& release) {
#ifdef CUCO_STATS
  const long long c0 = w.wait ? clock64() : 0;
  wait_landed(w.groups - w.last[w.head]);
  if (w.wait) *w.wait += clock64() - c0;
#else
  wait_landed(w.groups - w.last[w.head]);
#endif
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
  release(w.round[w.head]);
  note(w.log, EV_RETIRE, 0, 0);
  w.head = (w.head + 1) & (MAXCAP - 1);
  --w.count;
}

// open round (edge, tile): retire the oldest past the cap, then record it
template <class R, class Release>
__device__ __forceinline__ void push(Window<R>& w, const R& r, int edge, int tile,
                                     Release&& release) {
  if (w.count >= w.cap) retire_oldest(w, release);
  const int i = (w.head + w.count) & (MAXCAP - 1);
  w.round[i] = r;
  w.last[i] = w.groups;
  ++w.count;
  note(w.log, EV_PUSH, edge, tile);
}

// the bulk stores of a piece of the newest round are issued: one group
// (the slot is written again only after wait_read_all)
template <class R>
__device__ __forceinline__ void commit_piece(Window<R>& w) {
  commit_group();
  ++w.groups;
  w.last[(w.head + w.count - 1) & (MAXCAP - 1)] = w.groups;
}

// retire every round (a drain point, numbered `point` in the log)
template <class R, class Release>
__device__ __forceinline__ void drain(Window<R>& w, Release&& release, int point) {
  while (w.count) retire_oldest(w, release);
  note(w.log, EV_DRAIN, point, 0);
}

// The threads 0 .. NTH - 1 (met by `sync`) send `bytes` (a multiple of 16,
// both ends 16-byte aligned) from global `src` to global `dst` as pieces of
// `slot_bytes`: each piece loaded through registers (DEPTH 16-byte loads in
// flight a thread, through L2: other CTAs may have written the source),
// staged in `slot` once the owner has seen the slot's last bulk store read
// it (waited after the piece's first loads are out), then bulk-stored by
// the owner as one group of the newest round.
template <int NTH, int DEPTH, class R, class Sync>
__device__ __forceinline__ void ship(Window<R>& w, char* slot, unsigned slot_bytes,
                                     const void* src, void* dst, size_t bytes, Sync&& sync) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* t = reinterpret_cast<uint4*>(slot);
  for (size_t p0 = 0; p0 < bytes; p0 += slot_bytes) {
    const unsigned len = (unsigned)(bytes - p0 < slot_bytes ? bytes - p0 : slot_bytes);
    const unsigned units = len / 16;
    const uint4* sp = s + p0 / 16;
    for (unsigned b0 = 0; b0 < units; b0 += DEPTH * NTH) {  // the same trips in every thread
      uint4 v[DEPTH];
      const unsigned u0 = b0 + threadIdx.x;
#pragma unroll
      for (int i = 0; i < DEPTH; ++i)
        if (u0 + i * NTH < units) v[i] = __ldcg(sp + u0 + i * NTH);
      if (b0 == 0) {  // the slot is free once its last bulk store has read it
#ifdef CUCO_STATS
        if (threadIdx.x == 0) wait_read_all(w.wait);
#else
        if (threadIdx.x == 0) wait_read_all();
#endif
        sync();
      }
#pragma unroll
      for (int i = 0; i < DEPTH; ++i)
        if (u0 + i * NTH < units) t[u0 + i * NTH] = v[i];
    }
    fence_to_async();
    sync();
    if (threadIdx.x == 0) {
      bulk_store(reinterpret_cast<char*>(dst) + p0, slot, len);
      commit_piece(w);
    }
  }
}

}  // namespace win
