"""Generated audio-seconds a second of wall: the audio of every call of the
window over the window (the first call's start to the last call's end),
on the host clock."""


def read(rec):
    if rec["kind"] != "generate":
        return None
    return sum(c["audio_s"] for c in rec["calls"]) / rec["window_s"]
