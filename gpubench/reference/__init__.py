"""The benchmark's plain NumPy reference and its controls. Imports neither
JAX, wah_tpu nor anything of wah_tpu_torch, and takes nothing the program
has made: it works every expected answer out again from the generated
inputs."""
