"""Encoder: the program's counter "encoder_graph.train_replays" (training
encodes replayed from the encoder's forward and backward CUDA graphs) over
the spans stretch, per micro-step (`spans.py`); 1 where every micro-step's
encode took its graphs. A program with no training graphs counts none of
"encoder_graph.train_*" and reads None."""
from port_bench import spans


def read(run):
    s = spans.of(run)
    if s is None or not any(name.startswith("encoder_graph.train_")
                            for name in s["counters"]):
        return None
    return spans.counter_per(run, "encoder_graph.train_replays")
