"""Images whose outputs returned within the window, over the window's length."""


def read(ctx):
    return ctx.window["images"] / ctx.window["seconds"]
