"""Bounded, backpressured chunk channels (a copy of ``repro.stream.channel``)."""

from .channel import Channel, ChannelClosed, StreamHandle

__all__ = ["Channel", "ChannelClosed", "StreamHandle"]
