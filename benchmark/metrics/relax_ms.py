"""relax_ms: mean milliseconds of the window's `relax_ca` calls (the Loop
relaxation layer, `structure/relax.py`), each from the call to the card's
synchronise after it (the benchmark's span); nothing where the cell's jobs
do not relax."""

START, END = "t_score", "t_relax"


def read(rec):
    spans = [j[END] - j[START] for j in rec["jobs"] if END in j and START in j]
    return 1e3 * sum(spans) / len(spans) if spans else None
