// Stand-in for csrc/launch.cuh on the CPU (see run.py): a cp.async copy is a
// memcpy run when its thread waits for its group, the latest moment the
// hardware may run it, or, with -DEMU_EAGER, when it is issued.
#pragma once
#include <cuda_runtime.h>
static inline cudaError_t use_device(int) { return cudaSuccess; }
struct EmuCopy { void* dst; const void* src; int bytes; };
inline thread_local std::vector<EmuCopy> emu_pending;
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline void emu_do(const EmuCopy& c) {
  std::memcpy(c.dst, c.src, c.bytes);
  std::memset((char*)c.dst + c.bytes, 0, 16 - c.bytes);
}
inline void cp_async16_part(void* smem, const void* gmem, int bytes) {
#ifdef EMU_EAGER
  emu_do({smem, gmem, bytes});
#else
  emu_pending.push_back({smem, gmem, bytes});
#endif
}
inline void cp_async16(void* smem, const void* gmem, bool valid) {
  cp_async16_part(smem, gmem, valid ? 16 : 0);
}
inline void cp_async_commit() { emu_groups.push_back(emu_pending); emu_pending.clear(); }
template <int Pending> inline void cp_async_wait() {
  while ((int)emu_groups.size() > Pending) {
    for (auto& c : emu_groups.front()) emu_do(c);
    emu_groups.erase(emu_groups.begin());
  }
}
