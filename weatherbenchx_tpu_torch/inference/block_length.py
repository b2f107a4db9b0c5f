"""Automatic optimal block-length selection for the stationary bootstrap.

A copy of ``weatherbenchx_tpu/inference/block_length.py`` (host numpy):
self-contained implementation of the Politis & White (2004) procedure with
the Patton, Politis & White (2009) correction — replacing the reference's
dependency on ``arch.bootstrap.optimal_block_length``
(``statistical_inference/bootstrap.py:403-439``), which is not available in
this environment.

References:
  Politis, D. N. & White, H. Automatic Block-Length Selection for the
    Dependent Bootstrap. Econometric Reviews 23:1, 53-70 (2004).
  Patton, A., Politis, D. N. & White, H. Correction to the above.
    Econometric Reviews 28:4, 372-375 (2009).
"""

import numpy as np


def optimal_block_length_stationary(x: np.ndarray) -> float:
  """Optimal mean block length for the stationary bootstrap of a 1-D series."""
  x = np.asarray(x, dtype=np.float64).reshape(-1)
  nobs = x.shape[0]
  if nobs < 8:
    raise ValueError(
        'Need at least 8 data points to estimate an optimal block length.')
  eps = x - x.mean()

  b_max = np.ceil(min(3 * np.sqrt(nobs), nobs / 3))
  kn = max(5, int(np.log10(nobs)))
  m_max = int(np.ceil(np.sqrt(nobs))) + kn

  # Empirical autocovariances up to lag m_max (biased, 1/n normalization).
  acv = np.array([
      (eps[: nobs - k] * eps[k:]).sum() / nobs
      for k in range(min(m_max, nobs - 1) + 1)
  ])
  if acv[0] == 0:
    return 1.0
  rho = acv / acv[0]

  # Bandwidth selection: smallest m such that the next kn autocorrelations
  # are all inside the +/- 2*sqrt(log10(n)/n) band.
  crit = 2 * np.sqrt(np.log10(nobs) / nobs)
  insignificant = np.abs(rho[1:]) < crit
  m_hat = None
  for m in range(len(insignificant) - kn + 1):
    if insignificant[m:m + kn].all():
      m_hat = m  # rho_{m+1}..rho_{m+kn} all insignificant
      break
  if m_hat is None:
    significant = np.nonzero(~insignificant)[0]
    m_hat = int(significant[-1]) + 1 if significant.size else 0
  big_m = min(max(2 * m_hat, 1), m_max, len(acv) - 1)

  k = np.arange(1, big_m + 1)
  ratio = k / big_m
  lam = np.where(ratio <= 0.5, 1.0, 2.0 * (1 - ratio))
  g_hat = 2.0 * np.sum(lam * k * acv[1:big_m + 1])
  sigma2_hat = acv[0] + 2.0 * np.sum(lam * acv[1:big_m + 1])
  d_sb = 2.0 * sigma2_hat ** 2
  if d_sb <= 0:
    return 1.0
  b_sb = ((2.0 * g_hat ** 2) / d_sb) ** (1 / 3) * nobs ** (1 / 3)
  if not np.isfinite(b_sb):
    return 1.0
  return float(min(max(b_sb, 1.0), b_max))
