"""idle_share (%): 1 − the union of the device's kernel and copy intervals
÷ the traced window, averaged over the cards of the run.  How far the host
holds the card back; moves the cell's rate."""


def read(run):
    summ = run["summaries"]
    shares = [1.0 - s["busy_s"] / s["window_s"] for s in summ if s["window_s"] > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None
