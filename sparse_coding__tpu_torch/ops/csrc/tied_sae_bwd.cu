// K2 `tied_sae_bwd_adam` on the stored code, in every moment tier, and K3
// `tied_sae_bwd_grads`: instantiations of tied_sae_bwd.cuh, which describes
// the kernel.

#include "tied_sae_bwd.cuh"

extern "C" {

// K2 on the stored code: `code` = c [M, B, N] bf16; the rest as `adam_entry`.
int sc_tied_sae_bwd_adam_tiers(const void* x, const void* dxh, const void* code, const void* nrm,
                               void* d_raw, void* mu, void* mu_scale, int mu_tier, void* nu,
                               void* nu_scale, int nu_tier, void* g_bias, const void* l1_over_b,
                               const void* bc, const void* seed, int seed_tile, float lr, float b1,
                               float b2, float eps, float omb1, float omb2, int M, int B, int N,
                               int D, void* stream) {
  return adam_entry<kStoredRoute>(x, dxh, code, nrm, d_raw, mu, mu_scale, mu_tier, nu, nu_scale, nu_tier,
                           g_bias, l1_over_b, bc, seed, seed_tile, lr, b1, b2, eps, omb1, omb2, M,
                           B, N, D, stream);
}

// K3. As K2 without Adam: x [B, D] bf16, dxh [M, B, D] bf16, c [M, B, N]
// bf16, nrm [M, N] f32, dhat_b [M, N, D] bf16 in; g_enc [M, N, D] f32 and
// g_bias [M, N] f32 out; l1_over_b [M] f32. Shape limits, stream and return
// code as K2's.
int sc_tied_sae_bwd_grads(const void* x, const void* dxh, const void* c, const void* nrm,
                          const void* dhat_b, void* g_enc, void* g_bias, const void* l1_over_b,
                          int M, int B, int N, int D, void* stream) {
  BwdArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.dxh = static_cast<const bf16*>(dxh);
  a.code = c;
  a.nrm = static_cast<const float*>(nrm);
  a.dhat_b = static_cast<const bf16*>(dhat_b);
  a.g_enc = static_cast<float*>(g_enc);
  a.g_bias = static_cast<float*>(g_bias);
  a.l1_over_b = static_cast<const float*>(l1_over_b);
  a.B = B, a.N = N, a.D = D;
  return launch<false, kF32, kF32, false>(a, M, reinterpret_cast<cudaStream_t>(stream));
}

// The wgmma mainloop's plan on the stored code (and K3's): `plan_entry`.
int sc_tied_sae_bwd_plan(int D, int int8_moments, int* out) { return plan_entry<false>(D, int8_moments, out); }

}  // extern "C"
