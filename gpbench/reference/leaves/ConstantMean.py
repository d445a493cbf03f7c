"""m(x) = c."""
PARAMS = ("c",)
SIGNED = ("c",)


def start(r, xmin, xmax):
    return {"c": 0.01}


def value(p, x):
    return p["c"].expand(x.shape[0])
