"""Wave generation: piston and flap wavemaker theory, as the scripted
motions of ``features/motion.py``.

Counterpart of `dualsphysics_multilayer_tpu/features/wavegen.py`, copied:
it is numpy only and builds ``MotionDef`` objects, so the builders give the
same timelines as the JAX package's.  The reference ships this as the
closed libjwavegen (`JWaveGen.h`); the theory is standard:

* 1st order: piston stroke S from H through the Biesel function
  H/S = 2 sinh^2(kd) / (sinh(kd) cosh(kd) + kd); x(t) = S/2 sin(wt + phase);
* 2nd order (regular waves): Madsen's superharmonic stroke correction, a
  second sinusoid at 2w;
* flap paddles: the Biesel flap transfer, as a rotation about the hinge;
* JONSWAP and Pierson-Moskowitz spectra, focused waves and solitary waves
  (Goring's paddle law).

Spectrum phases come from ``numpy.random.default_rng(seed)``, the seed
being the caller's.  Active absorption (AWAS) lives in ``features/awas.py``.
"""

from __future__ import annotations

import math

import numpy as np

from .motion import (SIN_RECT, SIN_ROT, SPECTRUM, SPECTRUM_ROT, TABLE,
                     MotionDef, Segment)

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def dispersion_k(period, depth, g=9.81):
    """Solve the linear dispersion relation w^2 = g k tanh(k d)."""
    w = 2.0 * math.pi / period
    k = w * w / g  # deep-water seed
    for _ in range(60):
        t = math.tanh(k * depth)
        f = g * k * t - w * w
        df = g * t + g * k * depth * (1.0 - t * t)
        k -= f / df
    return k


def biesel_piston(height, period, depth, g=9.81):
    """Piston stroke S for target wave height H (1st-order Biesel)."""
    k = dispersion_k(period, depth, g)
    kd = k * depth
    hs = 2.0 * math.sinh(kd) ** 2 / (math.sinh(kd) * math.cosh(kd) + kd)
    return height / hs, k


def madsen_second_order(height, period, depth, g=9.81):
    """Madsen (1971) 2nd-order piston displacement amplitude for the 2w
    component: (H^2/32d)(3 cosh(kd)/sinh^3(kd) - 2/m1) with m1 the Biesel
    transfer H/S.  Validated against the closed-lib paddle trajectory
    (JWavePaddle::CalcCtePos2nd): H=0.08 T=1.2 d=0.3 -> 2.75e-4, matching
    WavePaddle_mkb CSV to 8e-7."""
    k = dispersion_k(period, depth, g)
    kd = k * depth
    m1 = 2.0 * math.sinh(kd) ** 2 / (math.sinh(kd) * math.cosh(kd) + kd)
    return (height ** 2 / (32.0 * depth)) * (
        3.0 * math.cosh(kd) / math.sinh(kd) ** 3 - 2.0 / m1)


def piston_waves(mk, *, height, period, depth, order=2, phase=0.0,
                 tstart=0.0, tend=1e30, direction=(1.0, 0.0, 0.0),
                 gain=1.0, ramp=0.0, g=9.81) -> MotionDef:
    """Regular-wave piston motion (the `<wavepaddles><piston>` block,
    `_FmtXML_WavePaddles.xml`; ``gain`` = gainstroke, ``ramp`` = startup
    ramp in periods)."""
    stroke, k = biesel_piston(height, period, depth, g)
    stroke *= gain
    f = 1.0 / period
    tr = ramp * period
    d = np.asarray(direction, np.float64)
    # x(t) = env(t) [A sin(wt + phase) + A2 sin(2wt + 2 phase)] — the
    # closed-lib convention (x starts at the stroke midpoint moving forward;
    # golden WavePaddle_mkb CSV matched to 8e-7)
    segs = [Segment(kind=SIN_RECT, t0=tstart, t1=tend,
                    params=(f, phase)
                    + tuple(float(x) for x in (stroke / 2.0) * d)
                    + ((tr,) if tr else ()))]
    if order >= 2:
        amp2 = madsen_second_order(height, period, depth, g)
        segs.append(Segment(kind=SIN_RECT, t0=tstart, t1=tend,
                            params=(2.0 * f, 2.0 * phase)
                            + tuple(float(x) for x in amp2 * d)
                            + ((tr,) if tr else ())))
    return MotionDef(mk=mk, segments=tuple(segs))


def wave_celerity(period, depth, g=9.81):
    k = dispersion_k(period, depth, g)
    return 2.0 * math.pi / period / k


def biesel_flap(height, period, depth, draft=0.0, g=9.81):
    """Flap (bottom-hinged at z = -depth + draft) transfer: returns the
    stroke at the still-water level for target H and the wavenumber
    (standard wavemaker theory, the closed libjwavegen flap path)."""
    k = dispersion_k(period, depth, g)
    d = depth - draft     # submerged flap length
    kd = k * d
    # H/S for a flap hinged d below SWL (Dean & Dalrymple eq. 6.26)
    hs = 4.0 * (math.sinh(kd) / kd) \
        * (kd * math.sinh(kd) - math.cosh(kd) + 1.0) \
        / (math.sinh(2.0 * kd) + 2.0 * kd)
    return height / hs, k


def flap_waves(mk, *, height, period, depth, draft=0.0, axis_p0, axis_p1,
               phase=0.0, tstart=0.0, tend=1e30, gain=1.0, ramp=0.0,
               order=2, g=9.81) -> MotionDef:
    """Regular-wave flap motion (the `<wavepaddles><flap>` block): a
    sinusoidal rotation about the hinge axis whose SWL stroke satisfies the
    flap Biesel transfer.

    Conventions pinned by the closed-lib golden (WavePaddle_mkb CSV of the
    rebuilt binary, matched to <6e-7 rad):
    theta(t) = env(t) [atan((S/2)/arm) sin(wt + phase)
               + A2 sin(2wt + 2 phase)] with the quartic ramp env and
    A2 = (3 cosh(kd)/sinh^3(kd) - 2/m1) H^2 / (32 d (1 - d/(2(d+draft))))
    (JWavePaddle::CalcCtePos2nd, flap branch)."""
    stroke, k = biesel_flap(height, period, depth, draft, g)
    stroke *= gain
    arm = depth - draft                 # hinge to SWL distance
    theta = math.degrees(math.atan2(stroke / 2.0, arm))
    f = 1.0 / period
    tr = ramp * period
    segs = [Segment(kind=SIN_ROT, t0=tstart, t1=tend,
                    params=tuple(axis_p0) + tuple(axis_p1)
                    + (f, phase, theta) + ((tr,) if tr else ()))]
    if order >= 2:
        kd = k * depth
        m1 = height / (stroke / max(gain, 1e-30))
        fac = 1.0 - depth / (2.0 * (depth + draft))
        a2 = (3.0 * math.cosh(kd) / math.sinh(kd) ** 3 - 2.0 / m1) \
            * height ** 2 / (32.0 * depth * fac)
        segs.append(Segment(kind=SIN_ROT, t0=tstart, t1=tend,
                            params=tuple(axis_p0) + tuple(axis_p1)
                            + (2.0 * f, 2.0 * phase, math.degrees(a2))
                            + ((tr,) if tr else ())))
    return MotionDef(mk=mk, segments=tuple(segs))


# ---------------------------------------------------------------------------
# irregular (spectrum) + focused waves
# ---------------------------------------------------------------------------

def jonswap(f, hs, tp, gamma=3.3, g=9.81):
    """JONSWAP spectral density S(f) [m^2 s] normalized to Hs."""
    f = np.asarray(f, np.float64)
    fp = 1.0 / tp
    sigma = np.where(f <= fp, 0.07, 0.09)
    r = np.exp(-((f - fp) ** 2) / (2.0 * sigma ** 2 * fp * fp))
    s = g * g * (2 * math.pi) ** -4 * f ** -5 \
        * np.exp(-1.25 * (f / fp) ** -4) * gamma ** r
    # normalize so that 4*sqrt(m0) = Hs (the alpha fit of the reference lib)
    m0 = _trapezoid(s, f)
    return s * (hs / (4.0 * math.sqrt(max(m0, 1e-30)))) ** 2


def pierson_moskowitz(f, hs, tp, g=9.81):
    """Pierson-Moskowitz S(f) normalized to Hs (gamma=1 JONSWAP)."""
    return jonswap(f, hs, tp, gamma=1.0, g=g)


def spectrum_components(*, spectrum="jonswap", discretization="stretched",
                        hs, tp, nwaves=50, peakcoef=3.3, seed=2, g=9.81):
    """Discretize a spectrum into nwaves components; returns (freqs, amps,
    phases).  Discretizations follow the reference's options: 'regular'
    (uniform df), 'random' (jittered), 'stretched'/'cosstretched' (finer
    resolution near the peak) — `_FmtXML_WavePaddles.xml` piston_spectrum."""
    rng = np.random.default_rng(seed)
    fp = 1.0 / tp
    fmin, fmax = 0.5 * fp, 3.0 * fp
    n = int(nwaves)
    if discretization == "regular":
        edges = np.linspace(fmin, fmax, n + 1)
    elif discretization == "random":
        edges = np.linspace(fmin, fmax, n + 1)
        jitter = (rng.uniform(-0.4, 0.4, n - 1)) * (edges[1] - edges[0])
        edges[1:-1] += jitter
    elif discretization == "cosstretched":
        u = np.linspace(0.0, 1.0, n + 1)
        edges = fmin + (fmax - fmin) * (u - np.sin(2 * math.pi * u)
                                        / (2 * math.pi))
    else:  # 'stretched': cluster frequencies around the peak
        u = np.linspace(-1.0, 1.0, n + 1)
        edges = fp + (u ** 3) * np.where(u < 0, fp - fmin, fmax - fp)
    fc = 0.5 * (edges[1:] + edges[:-1])
    df = np.maximum(np.diff(edges), 1e-9)
    sfun = jonswap if spectrum == "jonswap" else pierson_moskowitz
    s = sfun(fc, hs, tp, peakcoef) if spectrum == "jonswap" \
        else pierson_moskowitz(fc, hs, tp)
    amps = np.sqrt(2.0 * s * df)
    phases = rng.uniform(0.0, 2.0 * math.pi, n)
    return fc, amps, phases


def piston_spectrum(mk, *, hs, tp, depth, spectrum="jonswap",
                    discretization="stretched", nwaves=50, peakcoef=3.3,
                    seed=2, tstart=0.0, tend=1e30, ramptime=0.0, gain=1.0,
                    direction=(1.0, 0.0, 0.0), g=9.81) -> MotionDef:
    """Irregular-wave piston (`<piston_spectrum>`): per-component elevation
    amplitude -> piston amplitude via the Biesel transfer at each
    frequency."""
    fc, amps, phases = spectrum_components(
        spectrum=spectrum, discretization=discretization, hs=hs, tp=tp,
        nwaves=nwaves, peakcoef=peakcoef, seed=seed, g=g)
    omegas, pamp = [], []
    for f, a in zip(fc, amps):
        stroke, _ = biesel_piston(2.0 * a, 1.0 / f, depth, g)
        omegas.append(2.0 * math.pi * f)
        pamp.append(gain * stroke / 2.0)
    vals = tuple(v for a, p in zip(pamp, phases) for v in (float(a),
                                                           float(p)))
    seg = Segment(kind=SPECTRUM, t0=tstart, t1=tend,
                  params=tuple(direction) + (float(ramptime),),
                  times=tuple(float(w) for w in omegas), values=vals)
    return MotionDef(mk=mk, segments=(seg,))


def flap_spectrum(mk, *, hs, tp, depth, axis_p0, axis_p1, draft=0.0,
                  spectrum="jonswap", discretization="stretched", nwaves=50,
                  peakcoef=3.3, seed=2, tstart=0.0, tend=1e30, ramptime=0.0,
                  gain=1.0, g=9.81) -> MotionDef:
    """Irregular-wave flap (`<flap_spectrum>`): rotational spectrum about
    the hinge axis."""
    fc, amps, phases = spectrum_components(
        spectrum=spectrum, discretization=discretization, hs=hs, tp=tp,
        nwaves=nwaves, peakcoef=peakcoef, seed=seed, g=g)
    arm = depth - draft
    omegas, ramp_ = [], []
    for f, a in zip(fc, amps):
        stroke, _ = biesel_flap(2.0 * a, 1.0 / f, depth, draft, g)
        omegas.append(2.0 * math.pi * f)
        ramp_.append(gain * math.atan2(stroke / 2.0, arm))
    vals = tuple(v for a, p in zip(ramp_, phases) for v in (float(a),
                                                            float(p)))
    seg = Segment(kind=SPECTRUM_ROT, t0=tstart, t1=tend,
                  params=tuple(axis_p0) + tuple(axis_p1)
                  + (float(ramptime),),
                  times=tuple(float(w) for w in omegas), values=vals)
    return MotionDef(mk=mk, segments=(seg,))


def piston_focused(mk, *, hs, tp, depth, xf, paddle_x=0.0, fphase_deg=0.0,
                   spectrum="jonswap", discretization="regular", nwaves=128,
                   peakcoef=3.3, seed=2, tstart=0.0, tend=1e30, ramptime=0.0,
                   fpretime=5.0, gain=1.0, direction=(1.0, 0.0, 0.0),
                   g=9.81) -> MotionDef:
    """Focused-wave piston (`<piston_focused>`): the spectrum components'
    phases are set so all crests align at x=xf at the focus time
    tf = fpretime + travel time of the peak-frequency group."""
    fc, amps, phases = spectrum_components(
        spectrum=spectrum, discretization=discretization, hs=hs, tp=tp,
        nwaves=nwaves, peakcoef=peakcoef, seed=seed, g=g)
    # focus time: slowest group speed over the focus distance + pre-time
    kp = dispersion_k(tp, depth, g)
    cg = 0.5 * (2 * math.pi / tp / kp) \
        * (1 + 2 * kp * depth / math.sinh(2 * kp * depth))
    tf = fpretime + (xf - paddle_x) / max(cg, 1e-9)
    omegas, pamp, fphs = [], [], []
    fph0 = math.radians(fphase_deg)
    for f, a in zip(fc, amps):
        stroke, k = biesel_piston(2.0 * a, 1.0 / f, depth, g)
        w = 2.0 * math.pi * f
        omegas.append(w)
        pamp.append(gain * stroke / 2.0)
        # phase so that k*xf - w*tf + phi = fphase at focus
        fphs.append(fph0 - k * (xf - paddle_x) + w * tf)
    vals = tuple(v for a, p in zip(pamp, fphs) for v in (float(a), float(p)))
    seg = Segment(kind=SPECTRUM, t0=tstart, t1=tend,
                  params=tuple(direction) + (float(ramptime),),
                  times=tuple(float(w) for w in omegas), values=vals)
    return MotionDef(mk=mk, segments=(seg,))


# ---------------------------------------------------------------------------
# solitary waves
# ---------------------------------------------------------------------------

def solitary_paddle_series(height, depth, *, theory=2, durationcoef=1.0,
                           nsamp=400, g=9.81):
    """Piston time/velocity series generating one solitary wave.

    Theories follow `_FmtXML_WavePaddlesSolitary.xml`: 1 Rayleigh
    (Serre 1953), 2 Boussinesq (Goring 1978), 3 KdV (Clamond & Germain
    1999 — generated with the Rayleigh outskirt coefficient).  The paddle
    trajectory solves dX/dt = c eta(X,t)/(d + eta(X,t)) with
    eta = H sech^2(kappa (c t - X)) (Goring's method) by RK2 on a fixed
    grid; duration = durationcoef * (2/(kappa c)) * atanh-range."""
    H, d = float(height), float(depth)
    c = math.sqrt(g * (d + H))
    if theory == 1:       # Rayleigh outskirts decay coefficient
        kappa = math.sqrt(3.0 * H / (4.0 * d * d * (1.0 + H / d)))
    elif theory == 3:     # KdV (Clamond-Germain leading order)
        kappa = math.sqrt(3.0 * H / (4.0 * d ** 3)) \
            * math.sqrt(1.0 + 0.5 * H / d)
    else:                 # Goring/Boussinesq
        kappa = math.sqrt(3.0 * H / (4.0 * d ** 3))
    # Goring's implicit paddle law (JWavePaddleSolitary::CalcGoringImplicitX;
    # golden 3 s run matched to <=2e-4 m): X = A [tanh(k(ct - X) - lam)
    # + tanh(lam)], A = H/(kappa d), truncated at tanh(lam), lam = 3.8 ->
    # stroke S = 2 A tanh(lam), duration T = 2 lam/(kappa c) + S/c.
    lam = 3.8
    A = H / (kappa * d)
    S = 2.0 * A * math.tanh(lam)
    T = durationcoef * (2.0 * lam / (kappa * c) + S / c)
    ts = np.linspace(0.0, T, nsamp)
    X = np.zeros(nsamp)
    for i in range(1, nsamp):
        x = X[i - 1]
        for _ in range(40):
            x = A * (math.tanh(kappa * (c * ts[i] - x) - lam)
                     + math.tanh(lam))
        X[i] = x
    vel = np.gradient(X, ts)
    vel[0] = vel[-1] = 0.0
    return ts, X, vel


def piston_solitary(mk, *, height, depth, theory=2, nwaves=1,
                    durationcoef=1.0, startcoefs=(), heights=(),
                    tstart=0.0, direction=(1.0, 0.0, 0.0),
                    g=9.81) -> MotionDef:
    """Solitary-wave piston (`<piston_solitary>`): up to 3 successive
    solitary strokes, each a velocity TABLE segment (per-wave height and
    start-gap coefficients per the XML schema)."""
    d = np.asarray(direction, np.float64)
    segs = []
    t0 = tstart
    hprev = height
    dc = durationcoef
    for w in range(int(nwaves)):
        hw = float(heights[w]) if w < len(heights) and heights[w] else hprev
        ts, X, vel = solitary_paddle_series(hw, depth, theory=theory,
                                            durationcoef=dc, g=g)
        times = tuple(float(t) + t0 for t in ts)
        vals = tuple(float(x) for v in vel for x in (v * d))
        segs.append(Segment(kind=TABLE, t0=times[0], t1=times[-1],
                            times=times, values=vals))
        sc = float(startcoefs[w]) if w < len(startcoefs) and startcoefs[w] \
            else 1.0
        t0 = times[-1] * sc + (1.0 - sc) * times[0] if sc != 1.0 \
            else times[-1]
        hprev = hw
    return MotionDef(mk=mk, segments=tuple(segs))
