"""Set-up: from the process's first line to the end of the warm-up (imports,
weights and inputs made on the card, kernels built or loaded, every shape
of the window run once), on the host clock."""


def read(rec):
    return rec["setup_s"]
