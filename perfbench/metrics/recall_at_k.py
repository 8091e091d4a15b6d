"""recall_at_k: mean recall@k of the checked answers against the float64 exact neighbours."""


def read(run):
    return run.recall
