"""Faults under the stub driver's timed path (torch.distributed.all_gather,
planted on every rank): `unchanged`, the gather does nothing and the
output stays as allocated; `exchange`, the exchange between ranks left
out, each rank's slice copied into every row; `altered`, one gathered
value altered where it is produced."""
import torch.distributed as dist


def plant(fault: str, setattr) -> None:
    gather = dist.all_gather
    if fault == "unchanged":
        def all_gather(outs, t, group=None, async_op=False):
            return None
    elif fault == "exchange":
        def all_gather(outs, t, group=None, async_op=False):
            for o in outs:
                o.copy_(t)
    elif fault == "altered":
        def all_gather(outs, t, group=None, async_op=False):
            gather(outs, t, group=group)
            outs[-1][0] += 1.0
    else:
        raise ValueError(f"no fault {fault!r}")
    setattr(dist, "all_gather", all_gather)
