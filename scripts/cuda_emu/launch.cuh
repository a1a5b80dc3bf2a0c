// Stand-in for csrc/launch.cuh on the CPU (see run.py): a cp.async copy is a
// memcpy run when its thread waits for its group, the latest moment the
// hardware may run it, or, with -DEMU_EAGER, when it is issued.
#pragma once
#include <cuda_runtime.h>
static inline cudaError_t use_device(int) { return cudaSuccess; }
struct EmuCopy { void* dst; const void* src; bool valid; };
inline thread_local std::vector<EmuCopy> emu_pending;
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline void emu_do(const EmuCopy& c) {
  if (c.valid) std::memcpy(c.dst, c.src, 16); else std::memset(c.dst, 0, 16);
}
inline void cp_async16(void* smem, const void* gmem, bool valid) {
#ifdef EMU_EAGER
  emu_do({smem, gmem, valid});
#else
  emu_pending.push_back({smem, gmem, valid});
#endif
}
inline void cp_async_commit() { emu_groups.push_back(emu_pending); emu_pending.clear(); }
template <int Pending> inline void cp_async_wait() {
  while ((int)emu_groups.size() > Pending) {
    for (auto& c : emu_groups.front()) emu_do(c);
    emu_groups.erase(emu_groups.begin());
  }
}
