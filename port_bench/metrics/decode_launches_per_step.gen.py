"""Kernel launches a decode step, in the traced call: the host's launch
calls between the program's ``encoder`` and ``decode_loop`` marks (the
decode loop, with the conditioning and the pattern's build and revert)
over the steps. A count."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "generate" or not tr or "decode_loop" not in tr["stages"]:
        return None
    launches = tr["stages"]["decode_loop"]["launches"]
    return launches / rec["shapes"]["steps"] if launches else None
