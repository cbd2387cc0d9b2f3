// Rates of the integer instructions the join kernels' steps are made of,
// on the card this runs on: per instruction (or pair of instructions) a
// kernel of 8 independent chains a thread, 32 warps an SM.  Built and run
// by probe_joins.py (nvcc -O3 for sm_90a), which parses the lines
// "<name> <ms> ms <rate> ..."; the rate is chain updates per clock and
// SM at 1980 MHz, and each 8 updates carry 2 more instructions of loop.
#include <cuda_runtime.h>
#include <stdio.h>
template <int OP>
__global__ void k(unsigned* out, unsigned a, unsigned b, int one, int n) {
  unsigned m[8];
  unsigned y = threadIdx.x * a + b, z = threadIdx.x ^ b;
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = threadIdx.x + i * b;
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (OP == 0) m[i] = m[i] + y;                                   // IADD3
      if (OP == 1) m[i] = m[i] ^ y;                                   // LOP3
      if (OP == 2) m[i] = min(m[i], y + (unsigned)i);                 // VIMNMX (imm add folded?)
      if (OP == 3) m[i] = __vimin3_u32(m[i], y, z);                   // VIMNMX3
      if (OP == 4) m[i] = min(m[i], y + m[(i + 1) & 7]);              // VIADDMNMX
      if (OP == 5) m[i] = m[i] * (unsigned)one + y;                   // IMAD
      if (OP == 6) m[i] = (m[i] == y) ? z : m[i];                     // ISETP + SEL
      if (OP == 7) m[i] = __vimin3_u32(m[i], y * (unsigned)one + m[(i + 1) & 7], z);  // IMAD + VIMNMX3
    }
    y += 0x9E3779B1u; z ^= y;
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s ^= m[i];
  if (s == 0x12345678u) out[0] = s;
}
template <int OP>
void run(const char* name, unsigned* out) {
  const int n = 4096, blocks = 132 * 8, threads = 256;  // 4 blocks an SM at a time
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  k<OP><<<blocks, threads>>>(out, 3, 5, 1, 16);
  cudaEventRecord(e0);
  k<OP><<<blocks, threads>>>(out, 3, 5, 1, n);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double ops = (double)blocks * threads * n * 8;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  printf("%s %.4f ms %.2f updates/clk/SM\n", name, ms,
         ops / (ms * 1e-3) / sms / 1.98e9);
}
int main() {
  unsigned* out; cudaMalloc(&out, 4);
  run<0>("IADD3", out); run<1>("LOP3", out); run<2>("VIMNMX", out); run<3>("VIMNMX3", out);
  run<4>("VIADDMNMX", out); run<5>("IMAD", out); run<6>("ISETP+SEL", out); run<7>("IMAD+VIMNMX3", out);
  return 0;
}
