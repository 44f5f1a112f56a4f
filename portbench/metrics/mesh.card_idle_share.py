"""The mean over the mesh's cards of each card's idle share of the traced
slice: 1 - (the union of that card's device operations) / (the slice's
wall)."""


def read(outcome, cell):
    idle = outcome.layer.get("card_idle")
    if not idle:
        return None
    return sum(idle.values()) / len(idle)
