"""Surface-fitting pipeline task: interpolated option rows -> fitted vol
surfaces with arbitrage diagnostics.

New capability beyond the reference (its IV handling stopped at 1-D time
interpolation): groups interpolated rows by underlying, builds per-expiry
smiles from the latest snapshot, fits the batched surface engine, and
stores the evaluated grid + diagnostics.

Symbol convention follows the reference's data
(``btc-20mar23-24500-c``, main.py:177-183): underlying-expiry-strike-cp.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from iv_engine import models
from iv_engine.pipeline import storage as st

SURFACES = "vol_surfaces"


def parse_symbol(symbol: str):
    """'btc-20mar23-24500-c' -> (underlying, expiry_str, strike, is_call)."""
    parts = symbol.split("-")
    if len(parts) < 4:
        return None
    try:
        strike = float(parts[-2])
    except ValueError:
        return None
    return parts[0], "-".join(parts[1:-2]), strike, parts[-1].lower() == "c"


def build_chains(df: pd.DataFrame, min_strikes: int = 4):
    """Latest-snapshot chains per (underlying, expiry): log-moneyness and
    iv arrays sorted by strike. Returns list of dicts.

    Quotes without a usable ``iv`` fall back to Black-Scholes inversion of
    ``mark_price`` (batched Newton, ``ops.black_scholes.implied_vol``) —
    the reference carried both columns but could only consume iv."""
    rows = []
    invert = []  # quotes needing price->iv inversion
    for symbol, sub in df.groupby("symbol"):
        parsed = parse_symbol(symbol)
        if parsed is None:
            continue
        und, exp, strike, is_call = parsed
        last = sub.sort_values("date").iloc[-1]
        rec = dict(underlying=und, expiry=exp, strike=strike,
                   S=float(last["underlying_price"]),
                   T=float(last["time_to_maturity"]))
        if np.isfinite(last["iv"]) and last["iv"] > 0:
            rec["iv"] = float(last["iv"])
            rows.append(rec)
        elif ("mark_price" in sub.columns
              and np.isfinite(last.get("mark_price", np.nan))
              and last["mark_price"] > 0):
            rec["price"] = float(last["mark_price"])
            rec["is_call"] = is_call
            rec["rate"] = float(last.get("interest_rate", 0.0) or 0.0)
            invert.append(rec)
    if invert:
        from iv_engine.ops.black_scholes import implied_vol
        price = jnp.asarray([r["price"] for r in invert])
        S = jnp.asarray([r["S"] for r in invert])
        K = jnp.asarray([r["strike"] for r in invert])
        T = jnp.asarray([max(r["T"], 1e-6) for r in invert])
        rt = jnp.asarray([r["rate"] for r in invert])
        is_call = jnp.asarray([r["is_call"] for r in invert])
        ivs = np.asarray(implied_vol(price, S, K, T, rt, is_call))
        for rec, iv_ in zip(invert, ivs):
            if np.isfinite(iv_) and 1e-4 < iv_ < 4.9:
                rec["iv"] = float(iv_)
                rows.append(rec)
    if not rows:
        return []
    frame = pd.DataFrame(rows)
    chains = []
    for (und, exp), grp in frame.groupby(["underlying", "expiry"]):
        grp = (grp.groupby("strike", as_index=False)
               .agg({"iv": "mean", "S": "mean", "T": "mean"})
               .sort_values("strike"))
        k = np.log(grp["strike"].to_numpy() / grp["S"].to_numpy())
        # dedupe at COMPUTE precision: the solvers run f32 on device, so
        # two x64-distinct strikes whose log-moneyness rounds to the same
        # f32 would make a zero-width knot interval (h=0 -> inf/NaN for
        # that surface, silently). Keep the first of each f32-equal run.
        keep = np.concatenate([[True], np.diff(k.astype(np.float32)) > 0])
        if not keep.all():
            grp, k = grp[keep], k[keep]
        if len(grp) < min_strikes:
            continue
        chains.append(dict(underlying=und, expiry=exp, k=k,
                           iv=grp["iv"].to_numpy(),
                           T=float(grp["T"].mean())))
    return chains


def pack_chain_group(group, E_pad: int, n_pad: int, dtype=np.float64):
    """Pad a list of ``(underlying, T-sorted slices)`` chains into one
    dense ``(B, E_pad, n_pad)`` batch: strike axes extend strictly
    monotonically, padded expiry slots repeat the last slice at
    epsilon-larger T (maturities stay strictly ascending), and
    ``quote_mask`` marks the real quotes. ONE definition shared by
    ``run_surface_fit`` and ``serve.build_session`` (round-4 review:
    the serving copy had drifted — no quote_mask, a dead 0.5 iv fill).

    Returns ``(k, iv, T, E_real, quote_mask)``.
    """
    B = len(group)
    k = np.zeros((B, E_pad, n_pad), dtype)
    iv = np.zeros((B, E_pad, n_pad), dtype)
    T = np.zeros((B, E_pad), dtype)
    E_real = np.zeros(B, np.int64)
    quote_mask = np.zeros((B, E_pad, n_pad), bool)
    for b, (_und, slices) in enumerate(group):
        E_real[b] = len(slices)
        for e in range(E_pad):
            c = slices[min(e, len(slices) - 1)]
            m = len(c["k"])
            k[b, e, :m] = c["k"]
            iv[b, e, :m] = c["iv"]
            quote_mask[b, e, :m] = e < len(slices)
            if m < n_pad:
                step = (c["k"][-1] - c["k"][0]) / max(m - 1, 1) or 1e-3
                k[b, e, m:] = c["k"][-1] + step * np.arange(
                    1, n_pad - m + 1)
                iv[b, e, m:] = c["iv"][-1]
            T[b, e] = c["T"] + max(0, e - (len(slices) - 1)) * 1e-3
    return k, iv, T, E_real, quote_mask


def run_surface_fit(config, store, limit: Optional[int] = None,
                    method: Optional[str] = None) -> dict:
    """Fit one surface per underlying from interpolated data and persist
    the evaluated grid + diagnostics.

    ``surface.smile_method`` selects cubic_spline / smoothing_spline /
    svi / essvi / sabr / rbf / ah; ``surface.lm_max_iters`` bounds LM
    calibration; ``surface.butterfly_penalty`` adds the no-arb hinge to
    SVI fits; ``surface.spline_bc`` picks the cubic boundary condition;
    ``surface.rbf_kernel`` / ``surface.rbf_smoothing`` shape the RBF
    path; ``surface.compute_local_vol`` persists Dupire local vol and
    risk-neutral density columns alongside the grid.
    """
    scfg = config.surface
    method = method or scfg.smile_method
    df = store.read(st.INTERPOLATED)
    if df.empty:
        return {"surfaces": 0, "reason": "no interpolated data"}
    chains = build_chains(df)
    if limit:
        chains = chains[:limit]
    if not chains:
        return {"surfaces": 0, "reason": "no usable chains"}

    by_und = {}
    for c in chains:
        by_und.setdefault(c["underlying"], []).append(c)

    # shape-bucket the underlyings: (E_pad, n_pad) chosen from a geometric
    # schedule so repeated runs hit a small fixed set of compiled shapes,
    # and underlyings sharing a bucket fit as ONE batch (was: one
    # compile + one dispatch per underlying; see ROADMAP #1)
    def _pow2_at_least(x, lo):
        b = lo
        while b < x:
            b *= 2
        return b

    prepared = {}
    for und, slices in by_und.items():
        slices = sorted(slices, key=lambda c: c["T"])
        E = max(len(slices), 2)  # surface needs >= 2 expiries
        n = max(len(c["k"]) for c in slices)
        shape = (_pow2_at_least(E, 2), _pow2_at_least(n, 8))
        prepared.setdefault(shape, []).append((und, slices))

    # surface batches shard their underlying dim over the pipeline mesh
    # (same layout as PipelineRunner; transparent single-device
    # fallback). Batches pad to a mesh multiple with quote_mask-False
    # rows so every shard is equal; padded fits are dropped on unpack.
    from iv_engine.parallel.mesh import (pad_to_multiple,
                                         pipeline_mesh,
                                         shard_rows)
    mesh = pipeline_mesh(config.processing.mesh_shape,
                         config.processing.mesh_axis_names)
    n_mesh = mesh.shape[mesh.axis_names[0]] if mesh is not None else 1

    def dev(a):
        return shard_rows(mesh, jnp.asarray(a))

    # Andreasen-Huge compile-wall guard: AH batch scaling is sublinear
    # past ~512 surfaces and giant batches only buy longer compiles
    # (a dependent maturity x LM chain), so big buckets are fit in
    # <= surface.ah_max_batch chunks — identical results, bounded
    # program size. Other methods keep the whole bucket as one batch.
    max_b = getattr(scfg, "ah_max_batch", None) if method == "ah" else None
    buckets = []
    for shape, group in sorted(prepared.items()):
        if max_b:
            buckets += [(shape, group[i:i + max_b])
                        for i in range(0, len(group), max_b)]
        else:
            buckets.append((shape, group))

    out_frames = []
    n_fit = 0
    for (E_pad, n_pad), group in buckets:
        B = len(group)
        # real-quote mask: padded strikes and duplicated expiry slices
        # must not enter the fit_rmse statistic
        k, iv, T, E_real, quote_mask = pack_chain_group(group, E_pad,
                                                        n_pad)
        if n_mesh > 1:
            B_fit = pad_to_multiple(B, n_mesh)
            if B_fit != B:
                pads = B_fit - B
                k = np.concatenate([k, np.repeat(k[:1], pads, 0)])
                iv = np.concatenate([iv, np.repeat(iv[:1], pads, 0)])
                T = np.concatenate([T, np.repeat(T[:1], pads, 0)])
                quote_mask = np.concatenate(
                    [quote_mask,
                     np.zeros((pads,) + quote_mask.shape[1:], bool)])
        model = models.get(method)
        res_all = model.fit_eval(k, iv, T, quote_mask, scfg, dev=dev)
        keys = list(models.PERSIST_KEYS)
        if "w_grid_lo" in res_all:
            # compensated spline: persist the df64 low limb — the
            # (total_variance, total_variance_lo) pair reconstructs the
            # x64 oracle to ~1e-12 (models.spline)
            keys.append("w_grid_lo")
        if scfg.compute_local_vol:
            res_all = model.attach_local_vol(res_all, T=jnp.asarray(T),
                                             scfg=scfg)
            keys += ["local_vol", "density"]
        results = [
            {key: res_all[key][b:b + 1] for key in keys}
            for b in range(B)
        ]
        for b, (und, slices) in enumerate(group):
            res = results[b]
            n_fit += 1
            E_use = int(E_real[b])
            w = np.asarray(res["w_grid"][0])[:E_use]
            kg = np.asarray(res["k_grid"][0])[:E_use]
            ivg = np.asarray(res["iv_grid"][0])[:E_use]
            Ts = np.repeat(T[b, :E_use], w.shape[-1])
            sdf = pd.DataFrame({
                "underlying": und,
                "expiry_t": Ts,
                "log_moneyness": kg.ravel(),
                "total_variance": w.ravel(),
                "iv": ivg.ravel(),
            })
            if "w_grid_lo" in res:
                sdf["total_variance_lo"] = np.asarray(
                    res["w_grid_lo"][0])[:E_use].ravel()
            if "local_vol" in res:
                sdf["local_vol"] = np.asarray(
                    res["local_vol"][0])[:E_use].ravel()
                sdf["density"] = np.asarray(
                    res["density"][0])[:E_use].ravel()
            sdf["butterfly_ok"] = bool(res["butterfly_ok"][0])
            sdf["calendar_ok"] = bool(res["calendar_ok"][0])
            if "fit_rmse" in res:
                sdf["fit_rmse"] = float(res["fit_rmse"][0])
            out_frames.append(sdf)

    result = pd.concat(out_frames, ignore_index=True)
    store.write(SURFACES, result,
                upsert_keys=["underlying", "expiry_t", "log_moneyness"])
    return {
        "surfaces": n_fit,
        "grid_rows": len(result),
        "butterfly_ok": int(result.groupby("underlying")["butterfly_ok"]
                            .first().sum()),
        "calendar_ok": int(result.groupby("underlying")["calendar_ok"]
                           .first().sum()),
        "method": method,
    }
