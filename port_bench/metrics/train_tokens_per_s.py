"""Codec frames trained on a second of wall (a clip's 221 frames of 9
codebook tokens count as 221): the frames of every step of the window over
the window (the first step's start to the last step's end), on the host
clock."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return sum(c["tokens"] for c in rec["calls"]) / rec["window_s"]
