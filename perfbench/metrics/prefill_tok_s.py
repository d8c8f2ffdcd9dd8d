"""Prompt tokens prefilled over the window's whole time (host clock)."""


def read(rec):
    if not rec.prefills or rec.window_s <= 0:
        return None
    return rec.prefills * rec.batch * rec.seq / rec.window_s
