"""recall_at_k: k-recall@k (the ann-benchmarks definition): the share of a
query's true k nearest that its k returned ids hold, averaged over the rows
that correct.py samples from every batch of the window; the true
neighbours are the plain reference's exact search."""


def read(run):
    r = run.readings["recall_at_k"]
    return r if r == r else None
