"""Solver flight recorder: explainable scheduling decisions.

The solver stack reports only the winning schedule; this module captures
**why** it won.  An ``ExplainSink`` is threaded through the solvers
(``core.solver.kapla`` / ``interlayer`` / ``multinode``) when a solve is
run with ``explain=True`` and collects, per solve:

* the candidate **funnel** — enumerated -> validity-pruned (with the
  failing rule and the first overflowing layer) -> Pareto-pruned -> DP
  winner, per (start, stop) segment group;
* per-term **cost attribution** for the winner (MAC / REGF / GBUF / NoC
  / DRAM energy, roofline cycle terms, PE/node occupancy) whose term sum
  equals the schedule's scored energy;
* the top-k **runners-up** with cost deltas against the winner;
* the multi-node placement funnel, when the third tier ran.

The record is a plain JSON-safe dict: it attaches to
``NetworkSchedule.explain``, round-trips through ``to_json``/
``from_json`` and therefore persists inside ``ScheduleStore`` records
with no store changes.  ``render`` turns a record into the human
funnel-table + attribution-bar report behind
``python -m repro.obs explain``.

This module is rendering + collection only — it never imports the
solver, so ``repro.obs`` stays dependency-free and cycle-free.
"""
from __future__ import annotations

from typing import Dict, List, Optional

#: energy attribution term order (mirrors cost_model.ENERGY_TERMS; kept
#: here so rendering needs no solver import)
TERM_ORDER = ("mac_energy", "regf_energy", "gbuf_energy", "noc_energy",
              "dram_energy")

TERM_LABELS = {"mac_energy": "mac", "regf_energy": "regf",
               "gbuf_energy": "gbuf", "noc_energy": "noc",
               "dram_energy": "dram"}


class ExplainSink:
    """Collector the solvers write explain sections into.

    Deliberately dumb: a dict of named sections plus ``to_json``.  The
    solver layers own the section shapes; this class only guarantees the
    record stays a plain JSON value."""

    __slots__ = ("record",)

    def __init__(self):
        self.record: Dict = {"version": 1}

    def set(self, key: str, value) -> None:
        self.record[key] = value

    def set_funnel(self, funnel: Dict) -> None:
        """The inter-layer candidate funnel (``interlayer.funnel_from_
        batch``): per-(start, stop) enumerated/valid/kept counts, totals
        matching ``PruneStats``, and per-rule pruning attribution."""
        self.record["funnel"] = funnel

    def set_winner(self, winner: Dict) -> None:
        self.record["winner"] = winner

    def set_runners_up(self, runners: List[Dict]) -> None:
        self.record["runners_up"] = runners

    def set_multinode(self, info: Dict) -> None:
        self.record["multinode"] = info

    def to_json(self) -> Dict:
        return self.record


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _bar(frac: float, width: int = 24) -> str:
    frac = min(1.0, max(0.0, frac))
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def _fmt_seg(seg: Dict) -> str:
    gf = seg.get("granule_frac", 1.0)
    tag = "" if gf >= 1.0 else f" gf=1/{round(1.0 / gf)}"
    pipe = seg.get("pipelined")
    mode = "" if pipe is None else (" pipe" if pipe else " coarse")
    return f"[{seg['start']}:{seg['stop']}){tag}{mode}"


def render(record: Dict, width: int = 24) -> str:
    """Human-readable explain report: funnel table, attribution bars,
    runners-up, optional multi-node section."""
    lines: List[str] = []
    graph = record.get("graph", "?")
    obj = record.get("objective", "?")
    lines.append(f"explain[{graph}] objective={obj}")

    funnel = record.get("funnel")
    if funnel:
        tot = funnel.get("totals", {})
        en = tot.get("enumerated", 0)
        va = tot.get("after_validity", 0)
        ke = tot.get("after_pareto", 0)
        lines.append("candidate funnel (enumerated -> valid -> "
                     "pareto-kept):")
        vp = (en - va) / en * 100.0 if en else 0.0
        pp = (va - ke) / va * 100.0 if va else 0.0
        lines.append(f"  total {en:>7} -> {va:>7} -> {ke:>7}   "
                     f"({vp:.1f}% validity-pruned, "
                     f"{pp:.1f}% pareto-pruned)")
        for rule, info in sorted(funnel.get("pruned_by_rule",
                                            {}).items()):
            count = info.get("count", 0)
            if not count:
                continue
            layers = info.get("layers", {})
            top = sorted(layers.items(), key=lambda kv: -kv[1])[:3]
            at = ", ".join(f"{n} x{c}" for n, c in top)
            lines.append(f"  pruned by {rule}: {count}"
                         + (f"  (first overflow: {at})" if at else ""))
        win_groups = funnel.get("winner_groups")
        if win_groups:
            lines.append("  per winning segment "
                         "(enumerated / valid / kept):")
            shown = win_groups[:18]
            for g in shown:
                lines.append(f"    [{g['start']}:{g['stop']})"
                             f"  {g['enumerated']:>5} / {g['valid']:>5}"
                             f" / {g['kept']:>5}")
            if len(win_groups) > len(shown):
                lines.append(f"    ... ({len(win_groups) - len(shown)}"
                             " more segments)")

    winner = record.get("winner")
    if winner:
        lines.append(f"winner: energy {winner.get('energy_pj', 0):.4g} pJ"
                     f", latency {winner.get('latency_cycles', 0):.4g} cyc"
                     f", {len(winner.get('segments', []))} segment(s)")
        segs = winner.get("segments", [])
        if segs:
            lines.append("  chain: "
                         + " ".join(_fmt_seg(s) for s in segs))
        attrib = winner.get("attribution", {})
        total = sum(attrib.get(t, 0.0) for t in TERM_ORDER)
        if total > 0:
            lines.append("cost attribution (pJ):")
            for t in TERM_ORDER:
                v = attrib.get(t, 0.0)
                frac = v / total
                lines.append(f"  {TERM_LABELS[t]:<5} {_bar(frac, width)}"
                             f" {frac * 100.0:>5.1f}%  {v:.4g}")
        occ = winner.get("occupancy")
        if occ:
            lines.append(f"occupancy: {occ.get('avg_nodes_used', 0):.1f}"
                         f"/{occ.get('grid_nodes', 0)} nodes, "
                         f"{occ.get('avg_pes_used', 0):.1f}"
                         f"/{occ.get('pes_per_node', 0)} PEs per layer")
        cyc = winner.get("cycle_terms")
        if cyc:
            lines.append("roofline cycle terms: "
                         + ", ".join(f"{k}={v:.4g}"
                                     for k, v in sorted(cyc.items())))

    runners = record.get("runners_up") or []
    if runners:
        lines.append("runners-up (score delta vs winner):")
        for r in runners:
            segs = r.get("segments", [])
            chain = " ".join(_fmt_seg(s) for s in segs)
            lines.append(f"  #{r['rank']}  +{r['delta_frac'] * 100.0:.2f}%"
                         f"  {len(segs)} segment(s): {chain}")

    mn = record.get("multinode")
    if mn:
        f = mn.get("funnel", {})
        lines.append(f"multinode: {f.get('total', 0)} placements -> "
                     f"{f.get('after_validity', 0)} valid -> "
                     f"{f.get('kept', 0)} kept on the DP frontier")
        win = mn.get("winner")
        if win:
            parts = " ".join(
                f"segs[{p[0]}:{p[1]})->nodes{p[2]}"
                for p in win.get("parts", []))
            lines.append(f"  winner cost {win.get('cost', 0):.4g}: {parts}")
        for r in mn.get("runners_up", []):
            parts = " ".join(f"segs[{p[0]}:{p[1]})->nodes{p[2]}"
                             for p in r.get("parts", []))
            lines.append(f"  #{r['rank']}  +{r['delta_frac'] * 100.0:.2f}%"
                         f"  {parts}")
    return "\n".join(lines)


__all__ = ["ExplainSink", "render", "TERM_ORDER", "TERM_LABELS"]
