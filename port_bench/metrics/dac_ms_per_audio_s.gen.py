"""Milliseconds of the codec's decode an audio-second: the program's own
``stage_ms["dac"]`` (CUDA events) summed over every call but the traced
one, over the audio they made."""


def read(rec):
    if rec["kind"] != "generate":
        return None
    calls = [c for c in rec["calls"] if not c["traced"]]
    return (sum(c["stage_ms"]["dac"] for c in calls)
            / sum(c["audio_s"] for c in calls))
