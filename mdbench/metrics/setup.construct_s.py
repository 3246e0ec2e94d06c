"""setup.construct_s: seconds of the program's from_arrays (the cell grid,
the state's upload and layout, the first force), on the host clock with
the cards synchronized after it."""


def read(ctx):
    return ctx.host.get("construct_s")
