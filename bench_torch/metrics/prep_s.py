"""Host seconds, once per run, to make the reusable object (the SpGEMM
plan, the ELL) and put it on the card."""


def read(run):
    return run.prep_s
