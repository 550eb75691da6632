"""The k-diffusion samplers' math (the k-sampler half of
sdxl_tpu/pipeline/sampler.py): their schedules on the host, their update
rules as plain tensor functions, and ``k_sample``, one Python loop over a
host-known schedule that drives any of the twelve methods with a model
given as a function.

- Schedules (numpy, f32 like the reference): ``k_timesteps`` (linspace,
  trailing, leading), ``karras_sigmas``, ``ays_sigmas``, ``k_schedule``
  (linear, karras, ays, ays_sd15, trailing, leading; karras's and ays's
  fractional timesteps interpolated from log sigma),
  ``rescale_zero_terminal_snr``, and each method's per-step extras
  (``m3_scan_extras``, ``mid_scan_extras``, ``lms_scan_coeffs``,
  ``unipc_scan_extras``). They are computed once per request and moved to
  the device once.
- Step math (torch): ``k_step_update`` (euler, dpmpp, euler_a,
  dpmpp_sde), ``dpmpp_3m_sde_update``, ``heun_proposal`` /
  ``heun_combine``, ``mid_proposal`` / ``mid_combine`` (dpm2, dpm2_a,
  dpmpp_2s_a), ``unipc_step_update``. Sigmas are 0-d tensors on the
  latent's device; a flag the host knows from the schedule (the first
  step, a warm-up order) is a Python bool and picks its branch in Python,
  where the reference masks both with a where.

The loop reads nothing back to the host: the multistep histories are
tensors carried on the device and every per-step scalar is an index into
a device copy of the schedule.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

K_SAMPLERS = ("euler", "dpmpp", "euler_a", "dpmpp_sde", "dpmpp_3m_sde",
              "unipc", "heun", "euler_cfgpp", "dpm2", "dpm2_a",
              "dpmpp_2s_a", "lms")
K_STOCHASTIC = ("euler_a", "dpmpp_sde", "dpmpp_3m_sde", "dpm2_a",
                "dpmpp_2s_a")
# a second model evaluation at the log-space mid sigma between grid points
K_MID = ("dpm2", "dpm2_a", "dpmpp_2s_a")
SCHEDULES = ("linear", "karras", "ays", "ays_sd15", "trailing", "leading")

# Align Your Steps (Sabour et al. 2024, arXiv:2404.14507): the published
# 10-step noise levels for SDXL and SD 1.5
AYS_SIGMAS_SDXL = (14.615, 6.315, 3.771, 2.181, 1.342,
                   0.862, 0.555, 0.380, 0.234, 0.113)
AYS_SIGMAS_SD15 = (14.615, 6.475, 3.861, 2.697, 1.886,
                   1.396, 0.963, 0.652, 0.399, 0.152)

F32 = np.float32


# ---------------------------------------------------------------------------
# schedules (host, numpy)
# ---------------------------------------------------------------------------

def scaled_linear_alphas_cumprod(n_steps: int = 1000) -> np.ndarray:
    """SD's scaled-linear beta schedule -> cumulative alphas (float32)."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, n_steps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def rescale_zero_terminal_snr(alphas_cumprod) -> np.ndarray:
    """The ᾱ table rescaled to zero terminal SNR (Lin et al. 2023,
    arXiv:2305.08891 alg. 1, on sqrt(ᾱ): shift the last entry to 0, keep
    the first, square). The terminal zero would make sigma infinite, so
    it is stored as 2**-24, diffusers' sentinel for the same table."""
    s = np.sqrt(np.asarray(alphas_cumprod, np.float64))
    s0, s_t = s[0], s[-1]
    s = (s - s_t) * (s0 / (s0 - s_t))
    out = (s ** 2).astype(np.float32)
    out[-1] = 2.0 ** -24
    return out


def host_table(alphas_cumprod) -> np.ndarray:
    """The ᾱ table as f32 numpy (one device-to-host copy of a tensor)."""
    if isinstance(alphas_cumprod, torch.Tensor):
        alphas_cumprod = alphas_cumprod.detach().cpu().numpy()
    return np.asarray(alphas_cumprod, np.float32)


def sigma_table(alphas_cumprod) -> np.ndarray:
    """sqrt((1 - ᾱ) / ᾱ) in f32, the k-samplers' sigma of each t."""
    a = host_table(alphas_cumprod)
    return np.sqrt((F32(1.0) - a) / a)


def karras_sigmas(sigma_min: float, sigma_max: float, n: int,
                  rho: float = 7.0) -> np.ndarray:
    """Karras et al. 2022 (arXiv:2206.00364 eq. 5), descending."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    inv = 1.0 / rho
    return ((sigma_max ** inv + ramp * (sigma_min ** inv - sigma_max ** inv))
            ** rho).astype(np.float32)


def k_timesteps(step_start: int, n_steps: int, n_train: int,
                spacing: str = "linspace") -> np.ndarray:
    """diffusers' timestep spacings, high -> low: "linspace"
    (linspace(0, n_train-1, n) rounded), "trailing" (the first step at
    t = n_train-1, uniform n_train/n spacing, in closed form so that every
    count gives exactly n entries) and "leading" (arange(n) *
    (n_train//n) + 1, reversed). step_start > 0 keeps the full grid's
    spacing and takes its entries below t = n_train - step_start (at
    least the last one)."""
    if spacing in ("trailing", "leading") and n_steps > n_train:
        raise ValueError(
            f"n_steps ({n_steps}) > n_train ({n_train}) is invalid for "
            f"timestep_spacing='{spacing}' (diffusers' set_timesteps raises "
            "the same way; the leading grid would collapse every step onto "
            "t=1)")
    if spacing == "trailing":
        ts_full = (np.round(n_train - np.arange(n_steps, dtype=np.float64)
                            * (n_train / n_steps)).astype(np.int32) - 1)
    elif spacing == "leading":
        step_ratio = n_train // n_steps
        ts_full = ((np.arange(0, n_steps) * step_ratio).round()
                   .astype(np.int32)[::-1] + 1)
    else:
        ts_full = (np.linspace(0, n_train - 1, n_steps).round()[::-1]
                   .astype(np.int32))
    if step_start <= 0:
        return ts_full
    ts = ts_full[ts_full < n_train - step_start]
    return ts if len(ts) else ts_full[-1:]


def ays_sigmas(n_steps: int, family: str = "sdxl") -> np.ndarray:
    """The AYS sigmas at n_steps (descending, no trailing zero): the
    published table at 10, else log-linearly retargeted."""
    table = AYS_SIGMAS_SDXL if family == "sdxl" else AYS_SIGMAS_SD15
    logt = np.log(np.asarray(table, dtype=np.float64))
    if n_steps != len(table):
        logt = np.interp(np.linspace(0.0, 1.0, n_steps),
                         np.linspace(0.0, 1.0, len(table)), logt)
    return np.exp(logt).astype(np.float32)


def _interp(x, xp, fp) -> np.ndarray:
    """jnp.interp's f32 arithmetic (numpy's interp works in f64): clamp
    at the ends, lerp inside."""
    x, xp, fp = (np.asarray(a, F32) for a in (x, xp, fp))
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(F32).eps)
    f = np.where(dx0, fp[i - 1],
                 fp[i - 1] + (delta / np.where(dx0, F32(1.0), dx)) * df)
    f = np.where(x < xp[0], fp[0], f)
    return np.where(x > xp[-1], fp[-1], f).astype(F32)


def _t_of_sigma(sig: np.ndarray, sigmas_full: np.ndarray) -> np.ndarray:
    """Fractional timesteps of sigmas: log sigma interpolated against the
    table's (continuous-time conditioning)."""
    return _interp(np.log(sig), np.log(sigmas_full),
                   np.arange(len(sigmas_full), dtype=F32))


def k_schedule(alphas_cumprod, step_start: int, n_steps: int,
               schedule: str = "linear") -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps [n] f32, sigmas [n + 1] f32 with a trailing 0), both
    descending, on the host.

    linear / trailing / leading: the sigma table at k_timesteps' grid.
    karras: the Karras rho=7 ramp between the linear grid's end sigmas,
    over as many steps as that grid has. ays / ays_sd15: the published
    Align-Your-Steps sigmas; step_start > 0 keeps those at or below the
    handoff's sigma on the scaled-linear table (at least the last).
    karras and ays condition the UNet on fractional timesteps."""
    sigmas_full = sigma_table(alphas_cumprod)
    n_train = len(sigmas_full)
    spacing = schedule if schedule in ("trailing", "leading") else "linspace"
    lin_ts = k_timesteps(step_start, n_steps, n_train, spacing)
    if schedule in ("ays", "ays_sd15"):
        sig_k = ays_sigmas(n_steps, "sdxl" if schedule == "ays" else "sd15")
        if step_start > 0:
            alphas = scaled_linear_alphas_cumprod(n_train).astype(np.float64)
            t_hi = n_train - step_start - 1
            bound = float(np.sqrt((1 - alphas[t_hi]) / alphas[t_hi]))
            kept = sig_k[sig_k <= bound]
            sig_k = kept if len(kept) else sig_k[-1:]
        ts = _t_of_sigma(sig_k, sigmas_full)
    elif schedule == "karras":
        smin, smax = sigmas_full[0], sigmas_full[int(lin_ts[0])]
        inv = F32(1.0 / 7.0)
        ramp = np.linspace(0, 1, len(lin_ts), dtype=F32)
        sig_k = ((smax ** inv + ramp * (smin ** inv - smax ** inv))
                 ** F32(7.0)).astype(F32)
        ts = _t_of_sigma(sig_k, sigmas_full)
    else:
        sig_k, ts = sigmas_full[lin_ts], lin_ts.astype(F32)
    return ts, np.concatenate([sig_k, np.zeros(1, F32)]).astype(F32)


def k_sigma_at(alphas_cumprod, t: int) -> float:
    """The sigma of the table's integer timestep t."""
    return float(sigma_table(alphas_cumprod)[t])


def k_sigma_max(alphas_cumprod, n_steps: int,
                schedule: str = "linear") -> np.float32:
    """The schedule's first sigma, the initial noise's scale (the AYS
    tables' top value is their own)."""
    return k_schedule(alphas_cumprod, 0, n_steps, schedule)[1][0]


# ---------------------------------------------------------------------------
# per-step extras (host, numpy)
# ---------------------------------------------------------------------------

def _prev(sig: np.ndarray, k: int) -> np.ndarray:
    """sig[i - k], with sig[0] where i < k (the warm-up's dummy)."""
    return np.concatenate([np.repeat(sig[:1], k), sig[:-k]])[:len(sig)]


def m3_scan_extras(sig: np.ndarray):
    """DPM++ 3M SDE: (sig[i-2], second-step flags)."""
    return _prev(sig, 2), np.arange(len(sig)) == 1


def ancestral_step_sigmas(sig, sig_next):
    """k-diffusion get_ancestral_step (eta 1): (sigma_down, sigma_up),
    (0, 0) at sigma_next = 0."""
    var = sig_next ** 2 * (sig ** 2 - sig_next ** 2) / sig ** 2
    sigma_up = np.minimum(sig_next, np.sqrt(np.maximum(var, F32(0))))
    sigma_down = np.sqrt(np.maximum(sig_next ** 2 - sigma_up ** 2, F32(0)))
    return sigma_down.astype(F32), sigma_up.astype(F32)


def mid_scan_extras(method: str, sigmas: np.ndarray, sigmas_full: np.ndarray):
    """(t_mid, sig_mid, sig_down, sig_up) of the K_MID samplers: the
    second evaluation at sqrt(sigma * target), target = sigma_next (dpm2)
    or the ancestral sigma_down, its timestep from log sigma."""
    sigmas = np.asarray(sigmas, F32)
    sig, sig_next = sigmas[:-1], sigmas[1:]
    if method == "dpm2":
        sig_down, sig_up = sig_next, np.zeros_like(sig_next)
    else:
        sig_down, sig_up = ancestral_step_sigmas(sig, sig_next)
    sig_mid = np.sqrt(sig * np.maximum(sig_down, F32(1e-20))).astype(F32)
    t_mid = _t_of_sigma(np.maximum(sig_mid, F32(1e-10)), sigmas_full)
    return t_mid, sig_mid, sig_down, sig_up


def lms_scan_coeffs(sigmas, order: int = 4) -> np.ndarray:
    """k-diffusion sample_lms's linear_multistep_coeff rows [n, order]
    (f64): coeff[i, j] = ∫_{sig[i]}^{sig[i+1]} Π_{k≠j, k<cur}
    (τ - sig[i-k]) / (sig[i-j] - sig[i-k]) dτ, cur = min(i+1, order),
    integrated exactly (the integrand is a polynomial of degree < order)
    in u = τ - sig[i]; rows are 0 for j >= cur."""
    sigmas = np.asarray(sigmas, np.float64)
    sig = sigmas[:-1]
    n = len(sig)
    idx = np.arange(n)
    r = np.stack([sig - sig[np.maximum(idx - k, 0)] for k in range(order)])
    cur = np.minimum(idx + 1, order)
    dt = sigmas[1:] - sig
    cols = []
    for j in range(order):
        c = [np.ones(n)] + [np.zeros(n)] * (order - 1)  # poly in u, low first
        # columns j >= cur divide by 0 where the history repeats sig[0];
        # they are zeroed below
        with np.errstate(divide="ignore", invalid="ignore"):
            for k in range(order):
                if k == j:
                    continue
                active = cur > k
                denom = np.where(active, r[k] - r[j], 1.0)
                c = [np.where(active,
                              ((c[deg - 1] if deg else 0.0) + r[k] * c[deg])
                              / denom, c[deg]) for deg in range(order)]
            integ = sum(c[deg] * dt ** (deg + 1) / (deg + 1)
                        for deg in range(order))
        cols.append(np.where(cur > j, integ, 0.0))
    return np.stack(cols, axis=1)


def unipc_scan_extras(sig: np.ndarray):
    """UniPC (diffusers' UniPCMultistepScheduler, order 2,
    lower_order_final): (sig[i-2], the corrector runs (i >= 1), the
    corrector's order is 2 (i >= 2), the predictor's order is 2 (neither
    the first nor the last step))."""
    n = len(sig)
    idx = np.arange(n)
    return _prev(sig, 2), idx >= 1, idx >= 2, (idx >= 1) & (idx <= n - 2)


# ---------------------------------------------------------------------------
# step math (torch)
# ---------------------------------------------------------------------------

def _lam(sigma: torch.Tensor) -> torch.Tensor:
    """lambda = -log(sigma), sigma clamped at 1e-10 (finite at 0)."""
    return -torch.log(torch.clamp(sigma, min=1e-10))


def k_step_update(method: str, lat, denoised, old_denoised, sigma, sigma_next,
                  sigma_prev, is_first: bool, noise=None):
    """One update of euler (EulerDiscrete), dpmpp (DPM-Solver++ 2M:
    first order on the first and the last step), euler_a (ancestral Euler:
    Euler to sigma_down, + noise * sigma_up) or dpmpp_sde (DPM-Solver++(2M)
    SDE, midpoint, independent normals for the Brownian tree; returns
    denoised on the last step). The stochastic methods take ``noise``, a
    standard normal of lat's shape, at the public loops' eta of 1."""
    if method == "euler":
        d = (lat - denoised) / sigma
        return lat + d * (sigma_next - sigma)
    if method == "euler_a":
        var = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2
        sigma_up = torch.minimum(sigma_next,
                                 torch.sqrt(torch.clamp(var, min=0.0)))
        sigma_down = torch.sqrt(
            torch.clamp(sigma_next ** 2 - sigma_up ** 2, min=0.0))
        d = (lat - denoised) / sigma
        x = lat + d * (sigma_down - sigma)
        return torch.where(sigma_next > 0, x + noise * sigma_up, x)
    lam, lam_next = -torch.log(sigma), _lam(sigma_next)
    h = lam_next - lam
    if method == "dpmpp_sde":
        em = -torch.expm1(-h - h)
        x = (sigma_next / sigma) * torch.exp(-h) * lat + em * denoised
        if not is_first:
            r = (lam - (-torch.log(sigma_prev))) / h
            x = x + 0.5 * em / r * (denoised - old_denoised)
        x = x + noise * sigma_next * torch.sqrt(-torch.expm1(-2.0 * h))
        return torch.where(sigma_next > 0, x, denoised)
    # dpmpp
    ratio = torch.where(sigma_next > 0, sigma_next / sigma, 0.0)
    em1 = -torch.expm1(-h)
    d_eff = denoised
    if not is_first:
        r = (lam - (-torch.log(sigma_prev))) / h
        denoised_d = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old_denoised
        d_eff = torch.where(sigma_next <= 0.0, denoised, denoised_d)
    return ratio * lat + em1 * d_eff


def dpmpp_3m_sde_update(lat, denoised, den1, den2, sigma, sigma_next,
                        sigma_prev, sigma_prev2, is_first: bool,
                        is_second: bool, noise):
    """DPM-Solver++(3M) SDE (k-diffusion sample_dpmpp_3m_sde, eta 1,
    s_noise 1, independent normals): the exponential decay toward
    denoised, then the history corrections, first order on the first
    step, second on the second, third after; the step sizes of the
    history come from the grid. Returns denoised on the last step."""
    lam = -torch.log(sigma)
    h = _lam(sigma_next) - lam
    h_eta = h * 2.0
    x = torch.exp(-h_eta) * lat - torch.expm1(-h_eta) * denoised
    if not is_first:
        lam_prev = -torch.log(sigma_prev)
        r0 = (lam - lam_prev) / h
        phi_2 = torch.expm1(-h_eta) / h_eta + 1.0
        d1_0 = (denoised - den1) / r0
        if is_second:
            x = x + phi_2 * d1_0
        else:
            r1 = (lam_prev - (-torch.log(sigma_prev2))) / h
            phi_3 = phi_2 / h_eta - 0.5
            d1_1 = (den1 - den2) / r1
            d1 = d1_0 + (d1_0 - d1_1) * r0 / (r0 + r1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            x = x + phi_2 * d1 - phi_3 * d2
    x = x + noise * sigma_next * torch.sqrt(-torch.expm1(-2.0 * h))
    return torch.where(sigma_next > 0, x, denoised)


def heun_proposal(lat, denoised, sigma, sigma_next):
    """Heun's Euler proposal, where its second evaluation happens."""
    d = (lat - denoised) / sigma
    return lat + d * (sigma_next - sigma)


def heun_combine(lat, denoised, x_2, denoised_2, sigma, sigma_next):
    """k-diffusion sample_heun (s_churn=0): the mean of the derivatives at
    (lat, sigma) and (x_2, sigma_next); plain Euler (x_2) on the last
    step, where x_2 and denoised_2 are not read."""
    d = (lat - denoised) / sigma
    d_2 = (x_2 - denoised_2) / torch.clamp(sigma_next, min=1e-10)
    return torch.where(sigma_next > 0,
                       lat + 0.5 * (d + d_2) * (sigma_next - sigma), x_2)


def mid_proposal(method: str, lat, denoised, sigma, sig_mid, sig_down):
    """The point of the K_MID samplers' second evaluation: the Euler
    half-step to sig_mid (dpm2, dpm2_a), or DPM-Solver++'s exponential one
    (dpmpp_2s_a, r = 1/2)."""
    if method == "dpmpp_2s_a":
        h = torch.log(sigma / torch.clamp(sig_down, min=1e-10))
        return (sig_mid / sigma) * lat - torch.expm1(-0.5 * h) * denoised
    d = (lat - denoised) / sigma
    return lat + d * (sig_mid - sigma)


def mid_combine(method: str, lat, denoised, x_2, denoised_2, sigma,
                sigma_next, sig_mid, sig_down, sig_up, noise=None):
    """The K_MID samplers' update, in the public loops' order: dpm2 steps
    along the derivative at (x_2, sig_mid), Euler on the last step;
    dpm2_a to sig_down, + noise * sig_up, Euler with no noise where
    sig_down is 0; dpmpp_2s_a the exponential step with denoised_2,
    Euler where sig_down is 0, + noise * sig_up wherever sigma_next > 0."""
    d = (lat - denoised) / sigma
    sm = torch.clamp(sig_mid, min=1e-10)
    if method == "dpm2":
        d_2 = (x_2 - denoised_2) / sm
        return torch.where(sigma_next > 0, lat + d_2 * (sigma_next - sigma),
                           lat + d * (sigma_next - sigma))
    euler = lat + d * (sig_down - sigma)
    if method == "dpm2_a":
        d_2 = (x_2 - denoised_2) / sm
        x = lat + d_2 * (sig_down - sigma) + noise * sig_up
        return torch.where(sig_down > 0, x, euler)
    h = torch.log(sigma / torch.clamp(sig_down, min=1e-10))
    x = (sig_down / sigma) * lat - torch.expm1(-h) * denoised_2
    x = torch.where(sig_down > 0, x, euler)
    return torch.where(sigma_next > 0, x + noise * sig_up, x)


def unipc_step_update(lat, denoised, m_prev, m_prev2, last_sample, sigma,
                      sigma_next, sigma_prev, sigma_prev2, use_corr: bool,
                      corr_o2: bool, pred_o2: bool):
    """One UniPC step (Zhao et al. 2023; diffusers' UniPCMultistepScheduler
    with predict_x0, bh2, order 2, lower_order_final) in sigma space: the
    UniC corrector refines this step's input from last_sample with the
    fresh denoised, then the UniP predictor steps to sigma_next. m_prev,
    m_prev2: the two previous denoised. Returns (new latent, corrected
    sample), the latter the next step's last_sample."""
    lam = -torch.log(sigma)
    lam_prev = -torch.log(sigma_prev)
    x_c = lat
    if use_corr:
        h_c = lam - lam_prev
        hh_c = -h_c
        h_phi_1_c = torch.expm1(hh_c)  # bh2: B_h = expm1(hh)
        d1_t = denoised - m_prev
        x_t_c = (sigma / sigma_prev) * last_sample - h_phi_1_c * m_prev
        if corr_o2:
            b1_c = (h_phi_1_c / hh_c - 1.0) / h_phi_1_c
            h_phi_2_c = (h_phi_1_c / hh_c - 1.0) / hh_c - 0.5
            b2_c = h_phi_2_c * 2.0 / h_phi_1_c
            r0_c = (-torch.log(sigma_prev2) - lam_prev) / h_c
            rho0_c = (b2_c - b1_c) / (r0_c - 1.0)
            rho1_c = b1_c - rho0_c
            d1_0_c = (m_prev2 - m_prev) / r0_c
            x_c = x_t_c - h_phi_1_c * (rho0_c * d1_0_c + rho1_c * d1_t)
        else:
            x_c = x_t_c - h_phi_1_c * (0.5 * d1_t)
    h = _lam(sigma_next) - lam
    h_phi_1 = torch.expm1(-h)
    pred = (sigma_next / sigma) * x_c - h_phi_1 * denoised
    if pred_o2:
        d1_0_p = (m_prev - denoised) / ((lam_prev - lam) / h)
        pred = pred - (h_phi_1 * 0.5) * d1_0_p
    return torch.where(sigma_next > 0, pred, denoised), x_c


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], object]


def k_sample(eps_fn: EpsFn, latent: torch.Tensor, method: str,
             ts: np.ndarray, sigmas: np.ndarray, *,
             sigmas_full: Optional[np.ndarray] = None,
             step_noise: Optional[torch.Tensor] = None,
             pin: Optional[Callable] = None,
             head_steps: int = 0,
             on_step: Optional[Callable] = None) -> torch.Tensor:
    """Run ``method`` over the host-known schedule (ts [n], sigmas [n+1])
    from the sigma-space latent.

    eps_fn(x, sigma, t, i) -> the model's epsilon at the sigma-space
    latent x ((eps, unconditional eps) for euler_cfgpp) in step i; sigma
    and t are 0-d tensors on the latent's device. step_noise [n, ...]: the stochastic
    methods' standard normals, one per step. pin(lat, i, sigma) ->
    lat: the inpainting pin before each step's evaluation. head_steps > 0
    runs only the first head_steps steps (stopping at sigmas[head_steps]).
    sigmas_full: the ᾱ table's sigmas (the K_MID samplers' mid
    timesteps). on_step(done, lat): called after each step with the steps
    done and the latent (the step previews).

    heun and the K_MID samplers skip their second evaluation on the last
    step (sigma_next = 0), where the reference's scan evaluates it and
    masks it out: the latent is the same, and n steps take 2n - 1 model
    evaluations."""
    device = latent.device
    n = len(ts)
    sig = torch.as_tensor(np.asarray(sigmas, F32), device=device)
    t_dev = torch.as_tensor(np.asarray(ts, F32), device=device)
    cfgpp = method == "euler_cfgpp"
    if method in K_MID:
        extras = mid_scan_extras(method, sigmas, sigmas_full)
        t_mid, s_mid, s_down, s_up = (torch.as_tensor(a, device=device)
                                      for a in extras)
    elif method == "lms":
        co = torch.as_tensor(lms_scan_coeffs(sigmas), dtype=torch.float32,
                             device=device)
    elif method == "unipc":
        _, use_corr, corr_o2, pred_o2 = unipc_scan_extras(
            np.asarray(sigmas[:-1], F32))
    lat = latent.float()
    z = torch.zeros_like(lat)
    old = den1 = den2 = d1 = d2 = d3 = m_prev = m_prev2 = z
    last_sample = lat
    for i in range(head_steps or n):
        sigma, sigma_next = sig[i], sig[i + 1]
        sigma_prev, sigma_prev2 = sig[max(i - 1, 0)], sig[max(i - 2, 0)]
        final = not sigmas[i + 1] > 0
        noise = None if step_noise is None else step_noise[i]
        if pin is not None:
            lat = pin(lat, i, sigma)
        eps = eps_fn(lat, sigma, t_dev[i], i)
        if cfgpp:
            eps, eps_u = eps
        denoised = lat - sigma * eps
        if cfgpp:
            # CFG++ (arXiv:2406.08070): toward the guided denoised along
            # the unconditional noise
            lat = denoised + sigma_next * eps_u
        elif method == "unipc":
            lat, last_sample = unipc_step_update(
                lat, denoised, m_prev, m_prev2, last_sample, sigma,
                sigma_next, sigma_prev, sigma_prev2, bool(use_corr[i]),
                bool(corr_o2[i]), bool(pred_o2[i]))
            m_prev2, m_prev = m_prev, denoised
        elif method == "dpmpp_3m_sde":
            lat = dpmpp_3m_sde_update(
                lat, denoised, den1, den2, sigma, sigma_next, sigma_prev,
                sigma_prev2, i == 0, i == 1, noise)
            den2, den1 = den1, denoised
        elif method == "heun":
            x_2 = heun_proposal(lat, denoised, sigma, sigma_next)
            denoised_2 = denoised  # not read on the last step
            if not final:
                denoised_2 = x_2 - sigma_next * eps_fn(x_2, sigma_next,
                                                       t_dev[i + 1], i)
            lat = heun_combine(lat, denoised, x_2, denoised_2, sigma,
                               sigma_next)
        elif method in K_MID:
            x_2 = mid_proposal(method, lat, denoised, sigma, s_mid[i],
                               s_down[i])
            denoised_2 = denoised  # not read on the last step
            if not final:
                sm = torch.clamp(s_mid[i], min=1e-10)
                denoised_2 = x_2 - sm * eps_fn(x_2, sm, t_mid[i], i)
            lat = mid_combine(method, lat, denoised, x_2, denoised_2, sigma,
                              sigma_next, s_mid[i], s_down[i], s_up[i],
                              noise)
        elif method == "lms":
            d = (lat - denoised) / sigma
            lat = (lat + co[i, 0] * d + co[i, 1] * d1 + co[i, 2] * d2
                   + co[i, 3] * d3)
            d3, d2, d1 = d2, d1, d
        else:
            lat = k_step_update(method, lat, denoised, old, sigma,
                                sigma_next, sigma_prev, i == 0, noise)
            old = denoised
        if on_step is not None:
            on_step(i + 1, lat)
    return lat


def model_evaluations(method: str, sigmas: np.ndarray,
                      head_steps: int = 0) -> int:
    """The model evaluations k_sample makes: one a step, two for heun and
    the K_MID samplers except on a last step (sigma_next = 0)."""
    steps = head_steps or len(sigmas) - 1
    if method not in ("heun",) + K_MID:
        return steps
    return steps + sum(1 for i in range(steps) if sigmas[i + 1] > 0)
