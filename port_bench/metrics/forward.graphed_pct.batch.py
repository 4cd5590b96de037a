"""forward.graphed_pct.batch: the share of the window's serving forwards
that replayed CUDA graphs, in percent, in the closed-loop cells:
100 x `forward_graphed` / (`forward_graphed` + `forward_eager`), the
pipeline's counters (one of them a forward), totals over the window.
Nothing where the program counts neither."""


def read(run):
    if run.mix["loop"] != "closed":
        return None
    graphed, eager = (run.stages.get(name, {}).get("total", 0)
                      for name in ("forward_graphed", "forward_eager"))
    if not graphed + eager:
        return None
    return 100.0 * graphed / (graphed + eager)
