"""Launch bootstrap (counterpart of ``apex_tpu/parallel/multiproc.py``;
reference: ``apex/parallel/multiproc.py``, a one-node launcher).

Under a launcher that starts one process a card and sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun``), this
brings up the default NCCL process group and the data-parallel mesh of
``transformer.parallel_state``, then runs the script as ``__main__``::

    torchrun --nproc_per_node 4 -m apex_tpu_torch.parallel.multiproc \\
        train.py --args...
"""

import os
import runpy
import sys

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.platform import DeviceLike


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device: DeviceLike = None):
    """Bring up the default process group from the launcher's
    environment; ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` set ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` where given. On the
    card (NCCL) unless ``device="cpu"`` (gloo)."""
    if coordinator_address is not None:
        host, port = str(coordinator_address).rsplit(":", 1)
        os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = host, port
    if num_processes is not None:
        os.environ["WORLD_SIZE"] = str(int(num_processes))
    if process_id is not None:
        os.environ["RANK"] = str(int(process_id))
    ps.initialize_model_parallel(device=device)


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    initialize_distributed()
    script = sys.argv[1]
    sys.argv = sys.argv[1:]
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
