"""python -m wah_tpu_torch.parallel N [--device cuda|cpu] [--save DIR]
[--cases MODULE] [--check FILE.npz]: the sharded codec's dry run over N
ranks (dryrun.py)."""
from .dryrun import main

if __name__ == "__main__":
    main()
