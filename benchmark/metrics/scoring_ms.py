"""scoring_ms: mean milliseconds of the window's `score_designs` and
`rank_per_target` calls (the Scoring layer, `sampling/scoring.py`), each
from the call to the card's synchronise after it (the benchmark's span);
nothing where the cell's jobs do not score."""

START, END = "t_sample", "t_score"


def read(rec):
    spans = [j[END] - j[START] for j in rec["jobs"] if END in j and START in j]
    return 1e3 * sum(spans) / len(spans) if spans else None
