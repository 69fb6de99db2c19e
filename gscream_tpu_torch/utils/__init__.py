"""Shared utilities: PNG IO, video, visualization, the code snapshot."""
