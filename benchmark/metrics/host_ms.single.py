"""The host's share of a single-image request: the entropy coding, the
stream files and the receiver's rebuild (the `stats=` of
CGICCodec.compress: entropy_s + files_s + rebuild_s), ms, mean over the
window's requests."""


def read(d):
    host = d.get("host_s")
    return 1e3 * sum(host) / len(host) if host else None
