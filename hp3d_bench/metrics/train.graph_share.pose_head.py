"""train.graph_share.pose_head: Share of the port's `pose_head` spans under
`train.step`, in the profiled train steps, that a replay of the head's CUDA
graphs served (its counter `pose_head.graph_replays`), in %. Nothing where
no such span carries a graph counter (`pose_head.graph_replays`,
`.graph_captures` or `.graph_eager`): a program without the graphed head."""

from hp3d_bench.program_spans import named, records

NAME = "train.graph_share.pose_head"
UNIT = "%"
LAYER = "pose-head SVD"
MOVES = "train_img_per_s"
SOURCE = "program_span"
COUNTERS = ("pose_head.graph_replays", "pose_head.graph_captures",
            "pose_head.graph_eager")


def read(layer):
    recs = records(layer)
    spans = named(recs, "pose_head", root="train.step") if recs else None
    if not spans or not any(c in r.counters for r in spans for c in COUNTERS):
        return None
    return 100.0 * sum(r.counters.get(COUNTERS[0], 0) for r in spans) / len(spans)
