"""The benchmark's plain PyTorch reference (wah_torch.py), for cells too
large for the NumPy one (gpubench/reference/) to check in a run's time.
Imports neither JAX, wah_tpu nor anything of wah_tpu_torch, and takes
nothing the program has made: it works every expected answer out again
from the generated inputs. It lives beside gpubench/reference/, whose
files import NumPy alone (gpubench/tests/test_gpubench_imports.py)."""
