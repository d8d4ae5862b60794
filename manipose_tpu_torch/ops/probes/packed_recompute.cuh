// K4's second half the other way, for ``run_probes packed`` (variant
// "recompute"): dV = P^T dO and dK = scale dS^T Q from transposed scores
// S^T = K Q^T and dP^T = V dO^T recomputed on the tensor cores, as K2's
// dK/dV pass does, instead of P^T and dS^T through the warp's shared
// memory. Two more products over d a window, and no scratch. The variant
// includes this file into a copy of attention.cu and calls
// packed_bwd_window_recompute in place of packed_bwd_window.
#pragma once

template <typename T, int D, int MT>
__device__ __forceinline__ void packed_bwd_window_recompute(
    const uint32_t* qs, const uint32_t* ks, const uint32_t* vs, const uint32_t* gs,
    uint32_t* /*scratch, unused*/, const uint32_t* zero, T* dq, T* dk, T* dv,
    long long pitch, int n, float scale) {
  using P = Packed<T, D>;
  constexpr int NT = 2 * MT;
  const int nt = (n + 7) >> 3, t = mp::lane_t();
  const float c = scale * LOG2E;
  float s[MT][NT][4], dp[MT][NT][4];
  mp::zero(s);
  mp::zero(dp);
#pragma unroll
  for (int kk = 0; kk < P::KS; ++kk) {
    uint32_t a[MT][P::PARTS][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a_staged<T>(a[mi], qs, n, P::LD, zero, 16 * mi, 8 * kk);
    mma_tiles<mp::Mma<T>>(s, a, nt, [&](int ni, uint32_t (&w)[2]) {
      load_b_staged(w, ks, n, P::LD, zero, 8 * ni, 8 * kk);
    });
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a_staged<T>(a[mi], gs, n, P::LD, zero, 16 * mi, 8 * kk);
    mma_tiles<mp::Mma<T>>(dp, a, nt, [&](int ni, uint32_t (&w)[2]) {
      load_b_staged(w, vs, n, P::LD, zero, 8 * ni, 8 * kk);
    });
  }
  // the softmax, keeping each row's log-sum-exp (log2 units) and delta
  float lse[MT][2], delta[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][ni][e] = 8 * ni + 2 * t + (e & 1) < n ? s[mi][ni][e] * c : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[mi][ni][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][ni][e] = exp2f(s[mi][ni][e] - mx[e >> 1]);
        l[e >> 1] += s[mi][ni][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      lse[mi][r] = mx[r] + log2f(l[r]);
      delta[mi][r] = 0.f;
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][ni][e] /= l[e >> 1];
        delta[mi][e >> 1] = fmaf(s[mi][ni][e], dp[mi][ni][e], delta[mi][e >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[mi][r] += __shfl_xor_sync(0xffffffffu, delta[mi][r], 1);
      delta[mi][r] += __shfl_xor_sync(0xffffffffu, delta[mi][r], 2);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[mi][ni][e] = s[mi][ni][e] * (dp[mi][ni][e] - delta[mi][e >> 1]);
      }
  }
  float scaled[MT][2], one[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) scaled[mi][r] = scale, one[mi][r] = 1.f;
  float acc[MT][P::NO][4];
  {  // dQ = scale dS K
    mp::zero(acc);
    const int steps = (8 * nt + P::KK - 1) / P::KK;
#pragma unroll
    for (int j = 0; j < 8 * NT / P::KK; ++j) {
      if (j < steps) {
        uint32_t a[MT][AccMma<T>::PARTS][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) acc_to_a<T>(a[mi], dp[mi], j);
        mma_tiles<AccMma<T>>(acc, a, P::NO, [&](int no, uint32_t (&w)[2]) {
          load_b_staged_rows<T>(w, ks, n, P::LD, zero, 8 * no, P::KK * j);
        });
      }
    }
    store_rows(dq, pitch, acc, scaled, n);
  }
  // S^T = K Q^T and dP^T = V dO^T: rows = keys, columns = queries
  mp::zero(s);
  mp::zero(dp);
#pragma unroll
  for (int kk = 0; kk < P::KS; ++kk) {
    uint32_t a[MT][P::PARTS][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a_staged<T>(a[mi], ks, n, P::LD, zero, 16 * mi, 8 * kk);
    mma_tiles<mp::Mma<T>>(s, a, nt, [&](int ni, uint32_t (&w)[2]) {
      load_b_staged(w, qs, n, P::LD, zero, 8 * ni, 8 * kk);
    });
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a_staged<T>(a[mi], vs, n, P::LD, zero, 16 * mi, 8 * kk);
    mma_tiles<mp::Mma<T>>(dp, a, nt, [&](int ni, uint32_t (&w)[2]) {
      load_b_staged(w, gs, n, P::LD, zero, 8 * ni, 8 * kk);
    });
  }
  // column j = 8 ni + 2t + (e & 1) is query j, whose lse and delta lane
  // 4 (j % 8) holds in row tile j / 16, half (j % 16) / 8
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = 4 * (2 * t + h);
      const float lj = __shfl_sync(0xffffffffu, lse[ni >> 1][ni & 1], src);
      const float dj = __shfl_sync(0xffffffffu, delta[ni >> 1][ni & 1], src);
      const bool valid = 8 * ni + 2 * t + h < n;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + h;
          s[mi][ni][e] = valid ? exp2f(fmaf(s[mi][ni][e], c, -lj)) : 0.f;
          dp[mi][ni][e] = s[mi][ni][e] * (dp[mi][ni][e] - dj);
        }
    }
  // dV = P^T dO and dK = scale dS^T Q over the queries below n
  const int steps = (8 * nt + P::KK - 1) / P::KK;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    mp::zero(acc);
#pragma unroll
    for (int j = 0; j < 8 * NT / P::KK; ++j) {
      if (j < steps) {
        uint32_t a[MT][AccMma<T>::PARTS][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) acc_to_a<T>(a[mi], pass == 0 ? s[mi] : dp[mi], j);
        mma_tiles<AccMma<T>>(acc, a, P::NO, [&](int no, uint32_t (&w)[2]) {
          load_b_staged_rows<T>(w, pass == 0 ? gs : qs, n, P::LD, zero, 8 * no, P::KK * j);
        });
      }
    }
    if (pass == 0) {
      store_rows(dv, pitch, acc, one, n);
    } else {
      store_rows(dk, pitch, acc, scaled, n);
    }
  }
}
