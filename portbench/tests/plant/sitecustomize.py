"""Faults of a launch over several ranks, planted at start-up in every
process of a run whose ``PYTHONPATH`` starts with this directory
(``conftest.planted``), by ``PLANT``: the last rank raises once it has
joined (``raises``), never returns (``hangs``) or holds ``flax``
(``module``); the launcher waits ``PLANT_DEADLINE`` seconds past the
window where that is given."""

import os
import sys
import time
import types

plant, rank, world = os.environ.get("PLANT", ""), os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
if rank is None and os.environ.get("PLANT_DEADLINE"):
    from portbench import ranks

    ranks.WARM_S = ranks.COLD_S = float(os.environ["PLANT_DEADLINE"])
elif rank is not None and int(rank) == int(world) - 1:
    if plant == "module":
        sys.modules["flax"] = types.ModuleType("flax")
    elif plant in ("raises", "hangs"):
        from portbench import ranks

        serve = ranks.serve

        def planted(device, rank, world):
            if plant == "raises":
                raise RuntimeError(f"rank {rank}: planted failure")
            while True:
                time.sleep(60)

        ranks.serve = lambda device, part, held: serve(device, planted, held)
