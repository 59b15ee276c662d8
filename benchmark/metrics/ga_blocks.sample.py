"""ga_blocks.sample: GA blocks the port ran per traced design job (its
`ga.blocks` counter over the traced slice, booked on every graph replay as
K1's launches are): the network's blocks times its denoiser calls, 600 for
6 blocks and T = 100; a job that leaves the GA path reads less.  None
where the port keeps no such counter or there was no traced slice."""


def read(rec):
    n, prof = rec.get("ga_blocks_traced"), rec.get("profile")
    if n is None or not prof:
        return None
    return n / prof["units"]
