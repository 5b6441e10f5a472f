// K2 `tied_sae_bwd_adam` with the code rebuilt on chip from x, the dictionary
// tile and the bias (`_code_tile(recompute=True)`), in every moment tier:
// instantiations of tied_sae_bwd.cuh, which describes the kernel.

#include "tied_sae_bwd.cuh"

extern "C" {

// K2 rebuilding the code: `code` = the bias [M, N] f32; the rest as
// `adam_entry`.
int sc_tied_sae_bwd_adam_tiers(const void* x, const void* dxh, const void* code, const void* nrm,
                               void* d_raw, void* mu, void* mu_scale, int mu_tier, void* nu,
                               void* nu_scale, int nu_tier, void* g_bias, const void* l1_over_b,
                               const void* bc, const void* seed, int seed_tile, float lr, float b1,
                               float b2, float eps, float omb1, float omb2, int M, int B, int N,
                               int D, void* stream) {
  return adam_entry<kRebuildRoute>(x, dxh, code, nrm, d_raw, mu, mu_scale, mu_tier, nu, nu_scale, nu_tier,
                          g_bias, l1_over_b, bc, seed, seed_tile, lr, b1, b2, eps, omb1, omb2, M,
                          B, N, D, stream);
}

// The wgmma mainloop's plan rebuilding the code: `plan_entry`.
int sc_tied_sae_bwd_plan(int D, int int8_moments, int* out) { return plan_entry<true>(D, int8_moments, out); }

}  // extern "C"
