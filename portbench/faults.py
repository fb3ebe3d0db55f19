"""Faults planted underneath a whole run, for the tests and
tools/readings.py: each wraps the index's ``search_collect`` so that its
answers are broken where they are produced. A run with one has to come out
not correct. The benchmark's own runs never use them."""


def wrap_collect(alter):
    """A fault for run.run_cell: the index's answers passed through
    ``alter(D, I)`` (host copies) as they are collected."""
    def fault(index):
        collect = index.search_collect

        def broken(handle):
            D, I = collect(handle)
            return alter(D.copy(), I.copy())
        index.search_collect = broken
        return index
    return fault


def one_answer_altered(D, I):
    """One id of each batch, a third of the way down, moved to the next row."""
    r = len(I) // 3
    I[r, 0] = (I[r, 0] + 1) % max(int(I.max()) + 1, 2)
    return D, I


def half_batch_left_out(D, I):
    """Only the first half of the batch searched; its answers fill the rest."""
    h = len(I) // 2
    D[h:2 * h], I[h:2 * h] = D[:h], I[:h]
    return D, I


FAULTS = {"one_answer_altered": one_answer_altered,
          "half_batch_left_out": half_batch_left_out}
