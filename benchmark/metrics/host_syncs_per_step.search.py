"""The points at which the host waits for the card (``host_syncs`` of
``audiobd_tpu_torch/utils/profiling.py``: device→host reads, host→device
copies from pageable memory), counted by the ``search_call`` spans inside
the traced window's ``search`` marks, over the window's search steps: a
call's upload of the hosts and its result, each epoch's batch plan and
summed loss. None where the spans are missing or carry no events, or their
steps disagree with the count."""


def read(r):
    from audiobd_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded") or not r.search_steps:
        return None
    spans = profiling.recorded(r.trace["spans"].get("search", []))
    steps = [s for s in spans if s.name == "search_step"]
    if len(steps) != r.search_steps or any(s.device_ms is None for s in steps):
        return None
    return sum(s.host_syncs for s in spans if s.name == "search_call") / r.search_steps
