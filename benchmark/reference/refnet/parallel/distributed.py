"""One process: the reference runs the whole batch itself."""


def rank_world():
    return 0, 1


def world_size() -> int:
    return 1


def all_reduce_sum(x):
    return x
