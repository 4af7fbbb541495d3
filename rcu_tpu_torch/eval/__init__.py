"""The direct eval (volume pipeline, CSV writers, run loop) and the staged
chain's offline engine (metric passes, subject loader, run registry)."""
