"""launches_per_merge: kernel launches a learned merge costs in the
phase-timed train: the sum of the program's ``launch.<wrapper>``
counters (every launch of a wrapper's kernel, those inside CUDA graph
replays included; a ``launch.<wrapper>.<mode>`` counter is a part of its
wrapper's and is not added) over its ``train.merges`` counter. Nothing
where the program keeps no such counters."""


def read(r):
    if not r.phases:
        return None
    merges = r.phases.get("train.merges", {}).get("count")
    launches = [v["count"] for k, v in r.phases.items()
                if k.startswith("launch.") and k.count(".") == 1]
    if not merges or not launches:
        return None
    return sum(launches) / merges
