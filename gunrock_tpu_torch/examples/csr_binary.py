"""mtx -> binary CSR cache converter (copy of
``gunrock_tpu/examples/csr_binary.py``; role of reference
examples/tools/csr_binary.cu:6-42): parse a matrix-market file once and
dump the raw CSR arrays, so that later runs skip parsing (the CLIs load a
``.csr`` file by its extension).

    python -m gunrock_tpu_torch.examples.csr_binary datasets/chesapeake.mtx out.csr
"""

from __future__ import annotations

import argparse
from pathlib import Path

from gunrock_tpu_torch.formats import coo_to_csr
from gunrock_tpu_torch.io.matrix_market import load_matrix_market


def main(argv=None):
    p = argparse.ArgumentParser(prog="csr_binary", description=__doc__)
    p.add_argument("market", help="input .mtx file")
    p.add_argument("output", nargs="?", default="", help="output .csr path")
    ns = p.parse_args(argv)
    _, coo = load_matrix_market(ns.market)
    csr = coo_to_csr(coo)
    out = Path(ns.output) if ns.output else Path(ns.market).with_suffix(".csr")
    csr.write_binary(out)
    print(f"wrote {out}: {csr.n_rows} vertices, {csr.nnz} edges")


if __name__ == "__main__":
    main()
