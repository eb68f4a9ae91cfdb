// Serving multi-head attention straight from the packed QKV projection, for
// Hopper (sm_90a): bf16 in and out, float32 scores, row sums and accumulation.
//
// Replaces: thunder_tpu/kernels/attn_onepanel.py::mha_from_qkv (the Pallas TPU kernel).
// For a packed qkv (B, T, 3H), head h, query t and key j (dh = 64, H = heads * 64):
//   q      = bf16( qkv[b, t, h*64 : h*64+64] * bf16(0.125) )           (0.125 = dh^-0.5, exact)
//   s[j]   = sum_d q[d] * qkv[b, j, H + h*64 + d]  (f32)  + (j < len[b] ? 0 : -FLT_MAX)
//   p[j]   = exp(s[j] - max_j s[j])                       (f32), z = sum_j p[j]
//   out[b, t, h*64 + d] = bf16( sum_j bf16(p[j]) * qkv[b, j, 2H + h*64 + d] / z )
// The mask is added, never -inf: a row of length 0 averages every key and stays
// finite, and padded query rows attend the valid keys like any other row.
//
// What bounds it on this card: operations. 4 * T^2 * 64 bf16 FLOP per (row,
// head) against 2 * T * 3 * 64 bytes of qkv in and T * 64 * 2 out: at T = 749
// about 250 operations a byte, so the tensor cores bound it, not memory.
//
// The kernel is mha_forward_kernel<false> of mha_forward.cuh, which the training
// forward (mha_train.cu) shares; its design (a streaming softmax over TMA-fed
// key tiles, wgmma for both products) is described there.
// The TPU kernel's head-pair lane packing (for Mosaic's 128-lane blocks) and
// its T % 128 requirement are not carried over: T is any length, since shared
// memory does not depend on it.

#include "mha_forward.cuh"

// qkv: (batch, t, 3 * heads * 64) bf16, 16-byte aligned; lengths: (batch,) int32;
// out: (batch, t, heads * 64) bf16. Returns cudaGetLastError().
extern "C" int thunder_mha_from_qkv(const void* qkv, const int* lengths, void* out, int batch, int t, int heads,
                                    void* stream) {
  return mha_fwd::launch<false>(qkv, lengths, out, nullptr, nullptr, 0.f, batch, t, heads, stream);
}
