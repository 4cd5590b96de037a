"""batcher.padded_rows_pct: the share of the rows the forwards ran that
were padding, in percent: 100 x (`rows_run` - `rows_real`) / `rows_run`,
the pipeline's counters of the padded bucket and of the images a forward
was given, totals over the window."""


def read(run):
    st = run.stages
    if run.mix["loop"] != "open" or "rows_run" not in st or \
            "rows_real" not in st or not st["rows_run"]["total"]:
        return None
    run_, real = st["rows_run"]["total"], st["rows_real"]["total"]
    return 100.0 * (run_ - real) / run_
