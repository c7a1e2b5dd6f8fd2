"""The paper's figures and tables on the port (counterpart of the JAX
package's `benchmarks/fig*.py`, `table3_tilesweep.py`, `batch_sweep.py`
and `run.py`): counts from each point's plain path, times from its packed
artifact on the hand-written kernels, at the H100's data-sheet peaks.
`python -m repro_torch.figures.run [--quick] [--device cuda|cpu]`."""
