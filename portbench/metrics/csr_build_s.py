"""Seconds the program spent building its CSR index during set-up: its
``csr_build`` and ``edge_endpoints`` spans (``backend/cuda/graph_index.py``)
in the set-up queries' traces, nested ones once."""


def read(rec):
    s = rec["setup"]["csr_build_s"]
    return s if s > 0 else None
