"""setup_s: Process start to the start of the window: imports, kernel library, weights on the card, voices,
warm-up."""
LAYER = 'end to end'
SOURCE = 'host_clock'
MOVES = None


def read(window):
    return window["setup_s"]
