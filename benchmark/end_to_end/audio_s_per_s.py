"""Seconds of audio whose request completed inside the window, over the
window's seconds: all the work over all the time."""


def read(run):
    return run.completed * run.audio_s_per_request / run.window_s
