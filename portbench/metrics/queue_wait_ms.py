"""Host milliseconds a request of the traced stretch waits, on average, between
falling due and being handed to the device."""


def read(r):
    return r.window.get("queue_wait_ms")
