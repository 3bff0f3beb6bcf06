"""setup_s: seconds from the process's start to the window's opening
(imports, card start-up, kernel build or load, weights, warm-up, and what
the cell's traffic needs before its window, such as a filled arena)."""


def read(data):
    return data.get("setup_s")
