"""Operations that synchronise the host with the card in one served
batch, counted by CUDA's sync-debug mode."""


def read(r):
    return r.get("syncs_per_unit")
