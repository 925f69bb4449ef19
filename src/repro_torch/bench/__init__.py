"""The paper's figure sweeps on the card (ports of `benchmarks/common.py`,
`fig8_apps.py`, `fig10_mem_divergence.py`, `fig11_ai.py`,
`fig13_divdeg.py`): ``python -m repro_torch.bench.fig11_ai [--device cpu]``."""
