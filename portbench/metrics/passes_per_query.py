"""Mean passes a query, as the port's entry returned them: levels of a BFS
or SSSP, SpMM passes of a batch, block passes of the async sweep. One
reader for every ``passes_per_query.<cell>``."""


def read(run):
    if not run.queries:
        return None
    return sum(q.passes for q in run.queries) / len(run.queries)
