"""Edges traversed by the window's queries over the window's seconds, in
millions: a search traverses the out-degree sum of the vertices it
reaches (Gunrock's convention), and a batch counts every search. One
reader for every ``mteps.<cell>``."""


def read(run):
    if not run.queries or run.window_s <= 0:
        return None
    return sum(w.edges_traversed for w in run.works) / run.window_s / 1e6
