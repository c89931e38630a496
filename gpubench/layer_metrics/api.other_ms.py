"""The rest of WahCodec's own host time in one round trip: the self time
of the program's wah.compress and wah.decompress spans (each call's time
outside its pad, validate, count and phase spans: conversion, sizes,
allocation, the return), in ms, the mean over the traced round trips."""

from gpubench import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, {"wah.compress", "wah.decompress"})
