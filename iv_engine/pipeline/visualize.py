"""Pipeline visualizer — matplotlib reports over the storage adapter.

Port of the reference's ``pipeline_visualizer.py`` (462 LoC) and the
plotting half of ``check_results.py:249-392``:

  * data-flow diagram with volume-scaled stage boxes
    (pipeline_visualizer.py:102-154) -> ``pipeline_data_flow.png``
  * per-symbol interpolation analysis: original vs interpolated IV/price +
    density (pipeline_visualizer.py:156-281) -> ``interpolation_analysis.png``
  * candle comparison: 1-min vs reconstructed candlesticks
    (pipeline_visualizer.py:283-390, check_results.py:249-392)
    -> ``candle_analysis.png``
  * vol-surface heatmap (new capability) -> ``surface_analysis.png``

All figures are written headless (Agg backend).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import pandas as pd

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from iv_engine.pipeline import storage as st  # noqa: E402


class PipelineVisualizer:
    def __init__(self, store, out_dir: str = "."):
        self.store = store
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _save(self, fig, name: str) -> str:
        path = os.path.join(self.out_dir, name)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    def data_flow_diagram(self) -> str:
        """Stage boxes scaled by row volume, with arrows
        (pipeline_visualizer.py:102-154)."""
        stages = [
            (st.TICKERS, "source\n(hourly tickers)"),
            (st.INTERPOLATED, "task 1\n(1-min interpolated)"),
            (st.MINUTE_CANDLES, "bridge\n(synthetic 1-min OHLCV)"),
            (st.RECONSTRUCTED, "task 2\n(5-min candles)"),
        ]
        counts = [self.store.count(t) for t, _ in stages]
        max_c = max(max(counts), 1)
        fig, ax = plt.subplots(figsize=(11, 4))
        for i, ((table, label), c) in enumerate(zip(stages, counts)):
            h = 0.25 + 0.6 * (c / max_c)
            ax.add_patch(plt.Rectangle((i * 2.4, -h / 2), 1.8, h,
                                       color=f"C{i}", alpha=0.75))
            ax.text(i * 2.4 + 0.9, 0, f"{label}\n{c:,} rows",
                    ha="center", va="center", fontsize=9)
            if i < len(stages) - 1:
                ax.annotate("", xy=(i * 2.4 + 2.4, 0),
                            xytext=(i * 2.4 + 1.8, 0),
                            arrowprops=dict(arrowstyle="->", lw=2))
        ax.set_xlim(-0.3, 9.6)
        ax.set_ylim(-0.8, 0.8)
        ax.axis("off")
        ax.set_title("pipeline data flow")
        return self._save(fig, "pipeline_data_flow.png")

    def interpolation_analysis(self, symbols: Optional[List[str]] = None,
                               max_symbols: int = 3) -> Optional[str]:
        """Original vs interpolated IV/price + density per symbol
        (pipeline_visualizer.py:156-281)."""
        out = self.store.read(st.INTERPOLATED, symbols=symbols)
        if out.empty:
            return None
        syms = sorted(out["symbol"].unique())[:max_symbols]
        fig, axes = plt.subplots(len(syms), 3,
                                 figsize=(14, 3.2 * len(syms)),
                                 squeeze=False)
        for r, sym in enumerate(syms):
            sub = out[out["symbol"] == sym].sort_values("date")
            orig = sub[~sub["is_interpolated"]] \
                if "is_interpolated" in sub.columns else sub.iloc[::60]
            axes[r][0].plot(sub["date"], sub["iv"], lw=0.7,
                            label="interpolated")
            axes[r][0].plot(orig["date"], orig["iv"], "o", ms=3,
                            label="original")
            axes[r][0].set_title(f"{sym} — iv", fontsize=9)
            axes[r][1].plot(sub["date"], sub["underlying_price"], lw=0.7)
            axes[r][1].plot(orig["date"], orig["underlying_price"], "o", ms=3)
            axes[r][1].set_title("underlying price", fontsize=9)
            axes[r][2].hist(sub["iv"].dropna(), bins=40, alpha=0.8)
            axes[r][2].set_title("iv density", fontsize=9)
            axes[r][0].legend(fontsize=7)
            for ax in axes[r]:
                ax.tick_params(labelsize=7)
        fig.autofmt_xdate()
        return self._save(fig, "interpolation_analysis.png")

    def candle_analysis(self, symbol: Optional[str] = None,
                        n_candles: int = 60) -> Optional[str]:
        """1-min vs 5-min hand-drawn candlesticks + volume
        (check_results.py:249-392)."""
        recon = self.store.read(st.RECONSTRUCTED)
        if recon.empty:
            return None
        symbol = symbol or recon["symbol"].iloc[0]
        recon = recon[recon["symbol"] == symbol].sort_values(
            "timestamp").head(n_candles)
        minute = self.store.read(st.MINUTE_CANDLES, symbols=[symbol])
        if minute.empty:
            # a cleared/absent minute_candles table returns a column-
            # less frame; sort_values('timestamp') on it KeyError'd and
            # took summary_report down with it (round-4 review) — skip
            # the figure like the other guards do
            return None
        minute = minute.sort_values("timestamp")
        minute = minute[
            (minute["timestamp"] >= recon["timestamp"].min())
            & (minute["timestamp"] <= recon["timestamp"].max()
               + pd.Timedelta(minutes=5))
        ]
        fig, axes = plt.subplots(2, 2, figsize=(14, 8))
        self._candlesticks(axes[0][0], minute, width_min=0.7)
        axes[0][0].set_title(f"{symbol} — 1-min source candles", fontsize=9)
        self._candlesticks(axes[0][1], recon, width_min=3.5)
        axes[0][1].set_title("5-min reconstructed candles", fontsize=9)
        axes[1][0].bar(minute["timestamp"], minute["volume"],
                       width=1 / (24 * 60), alpha=0.7)
        axes[1][0].set_title("1-min volume", fontsize=9)
        axes[1][1].bar(recon["timestamp"], recon["volume"],
                       width=5 / (24 * 60), alpha=0.7, color="C1")
        axes[1][1].set_title("5-min volume", fontsize=9)
        for row in axes:
            for ax in row:
                ax.tick_params(labelsize=7)
        fig.autofmt_xdate()
        return self._save(fig, "candle_analysis.png")

    @staticmethod
    def _candlesticks(ax, df, width_min: float):
        """Hand-drawn candlesticks (check_results.py:299-343 style)."""
        w = pd.Timedelta(minutes=width_min)
        for _, r in df.iterrows():
            color = "green" if r["close"] >= r["open"] else "red"
            ax.plot([r["timestamp"], r["timestamp"]], [r["low"], r["high"]],
                    color=color, lw=0.6)
            ax.add_patch(plt.Rectangle(
                (r["timestamp"] - w / 2, min(r["open"], r["close"])),
                w, abs(r["close"] - r["open"]) or 1e-9,
                color=color, alpha=0.85))

    def surface_analysis(self) -> Optional[str]:
        """IV-surface heatmap from the vol_surfaces table (new)."""
        from iv_engine.pipeline.surface_task import SURFACES
        surf = self.store.read(SURFACES)
        if surf.empty:
            return None
        und = surf["underlying"].iloc[0]
        sub = surf[surf["underlying"] == und]
        has_lv = "local_vol" in sub.columns
        fig, axes = plt.subplots(1, 2 if has_lv else 1,
                                 figsize=(16 if has_lv else 9, 5))
        axes = axes if has_lv else [axes]
        panels = [("iv", "implied vol", "fitted vol surface")]
        if has_lv:
            panels.append(("local_vol", "local vol",
                           "Dupire local vol"))
        for ax, (col, label, title) in zip(axes, panels):
            piv = sub.pivot_table(index="expiry_t",
                                  columns="log_moneyness", values=col)
            im = ax.pcolormesh(piv.columns, piv.index, piv.values,
                               shading="auto", cmap="viridis")
            fig.colorbar(im, ax=ax, label=label)
            ax.set_xlabel("log-moneyness")
            ax.set_ylabel("maturity (years)")
            ax.set_title(f"{und} {title}")
        return self._save(fig, "surface_analysis.png")

    def summary_report(self, symbol: Optional[str] = None) -> dict:
        """Census + generated figure paths
        (pipeline_visualizer.py:392-439). ``symbol`` scopes the
        per-symbol figures to one operator-chosen symbol (CLI
        ``--plot-symbol``, reference check_results.py:441-447)."""
        from iv_engine.pipeline.check_results import quick_summary
        report = quick_summary(self.store)
        report["figures"] = [
            p for p in (
                self.data_flow_diagram(),
                self.interpolation_analysis(
                    symbols=[symbol] if symbol else None),
                self.candle_analysis(symbol=symbol),
                self.surface_analysis(),
            ) if p
        ]
        return report
