"""``traced.py`` with the readers of a hybrid MoE cell's spans and
counters added to its ``METRICS``: runs of one cell with the port's spans
on, each device event put down to the span that launched it.

    python3 portbench/traced_hybrid.py --workload granite4h.longdoc --seeds 11 --seconds 51 \
        --trace 1

Takes ``traced.py``'s arguments.  The added readings, under ``spans`` in
each run's line: ``moe_drop_share.longdoc`` (the routed assignments
dropped over capacity, from the counters ``moe.assignments`` and
``moe.dropped``) and ``decode_mamba_device_ms.longdoc`` (the device time
the Mamba-2 decode layers launch, a decode step; ``--trace 1`` only).
"""
import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402

import traced  # noqa: E402

HYBRID_METRICS = {"moe_drop_share.longdoc": "%", "decode_mamba_device_ms.longdoc": "ms"}

if __name__ == "__main__":
    traced.T_PROCESS = T_PROCESS
    traced.METRICS.update(HYBRID_METRICS)
    sys.exit(traced.main())
