"""One rank of a gloo world of ``torch_world.run_world``: argv is
module:function, rank, size and the world's directory."""

import datetime
import importlib
import pickle
import sys


def main() -> None:
    target, rank, size, workdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/store", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=100))
    from lanczosplusplus_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    with open(f"{workdir}/kwargs.pkl", "rb") as f:
        kwargs = pickle.load(f)
    module, name = target.split(":")
    out = getattr(importlib.import_module(module), name)(mesh, **kwargs)
    with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
