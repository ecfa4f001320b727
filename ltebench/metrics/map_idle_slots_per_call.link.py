"""Idle MAP slots per link call: the slots that the decodes launched
(2 * max_iter each, `read_map_slots`) less the MAP passes that ran
(`read_map_passes`), over the calls of the measured window: the slots
whose run flag was clear."""


def read(ctx):
    from srslte_emane_tpu_torch.ops.fec import turbodecoder

    if not ctx["calls"] or not hasattr(turbodecoder, "read_map_slots"):
        return None
    return (turbodecoder.read_map_slots() - turbodecoder.read_map_passes()) / ctx["calls"]
