"""North star criterion 3 on the CPU: the port's engine replays the
facade-parity workload (``tests/torch_facade_parity_workload.py``: paged
churn, chunked prefill, learning with refits, release / re-admit, closed
loop) and reproduces all 31 arrays of ``tests/data/facade_parity_ref.npz``,
recorded from the JAX engine, to 1e-5 with equal NaN patterns — the
tolerance and checks of ``tests/test_serving_planes.py``'s replay."""
import numpy as np

from torch_facade_parity_workload import REF_PATH, compare, run_workload


def test_port_replays_the_facade_parity_reference():
    ref = np.load(REF_PATH)
    assert len(ref.files) == 31
    got = run_workload("cpu")
    assert compare(got, ref, atol=1e-5) <= 1e-5
