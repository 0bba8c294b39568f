// strobe-time: oscillate the wall clock between true time and true+delta
// every <period> ms for <duration> seconds, anchored to CLOCK_MONOTONIC so
// the strobe is immune to its own skew.
//
// TPU-rebuild of the reference helper (jepsen/resources/strobe-time.c):
// same CLI and behavior — compute the wall-vs-monotonic offset once, then
// alternate wall = mono + offset / wall = mono + offset + delta, finally
// restore wall = mono + offset and print the number of adjustments.
// Exit codes: usage -> 1, clock reads -> 1, settimeofday -> 2,
// nanosleep -> 3.
//
// usage: strobe-time <delta-ms> <period-ms> <duration-s>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <sys/time.h>

namespace {

constexpr int64_t kNanosPerSec = 1000000000LL;

int64_t to_nanos(const timespec &t) {
  return static_cast<int64_t>(t.tv_sec) * kNanosPerSec + t.tv_nsec;
}

timespec from_nanos(int64_t nanos) {
  timespec t;
  t.tv_sec = nanos / kNanosPerSec;
  t.tv_nsec = nanos % kNanosPerSec;
  if (t.tv_nsec < 0) {  // keep nsec in [0, 1e9)
    t.tv_sec -= 1;
    t.tv_nsec += kNanosPerSec;
  }
  return t;
}

int64_t monotonic_nanos() {
  timespec now;
  if (clock_gettime(CLOCK_MONOTONIC, &now) != 0) {
    std::perror("clock_gettime");
    std::exit(1);
  }
  return to_nanos(now);
}

int64_t wall_nanos(struct timezone *tz) {
  timeval tv;
  if (gettimeofday(&tv, tz) != 0) {
    std::perror("gettimeofday");
    std::exit(1);
  }
  return static_cast<int64_t>(tv.tv_sec) * kNanosPerSec +
         static_cast<int64_t>(tv.tv_usec) * 1000;
}

void set_wall_nanos(int64_t nanos, const struct timezone &tz) {
  timespec ts = from_nanos(nanos);
  timeval tv;
  tv.tv_sec = ts.tv_sec;
  tv.tv_usec = ts.tv_nsec / 1000;
  if (settimeofday(&tv, &tz) != 0) {
    std::perror("settimeofday");
    std::exit(2);
  }
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s <delta> <period> <duration>\n", argv[0]);
    std::fprintf(
        stderr,
        "Delta and period are in ms, duration is in seconds. Every period "
        "ms, adjusts the clock forward by delta ms, or, alternatively, back "
        "by delta ms. Does this for duration seconds, then exits. Useful "
        "for confusing the heck out of systems that assume clocks are "
        "monotonic and linear.\n");
    return 1;
  }

  const int64_t delta = static_cast<int64_t>(std::atof(argv[1]) * 1e6);
  const int64_t period = static_cast<int64_t>(std::atof(argv[2]) * 1e6);
  const int64_t duration = static_cast<int64_t>(std::atof(argv[3]) * 1e9);

  struct timezone tz;
  const int64_t normal_offset = wall_nanos(&tz) - monotonic_nanos();
  const int64_t weird_offset = normal_offset + delta;
  const int64_t end = monotonic_nanos() + duration;
  const timespec sleep_for = from_nanos(period);

  bool weird = false;
  int64_t count = 0;
  while (monotonic_nanos() < end) {
    set_wall_nanos(monotonic_nanos() + (weird ? normal_offset : weird_offset),
                   tz);
    weird = !weird;
    count += 1;
    timespec rem;
    if (nanosleep(&sleep_for, &rem) != 0) {
      std::perror("nanosleep");
      std::exit(3);
    }
  }

  set_wall_nanos(monotonic_nanos() + normal_offset, tz);
  std::printf("%lld\n", static_cast<long long>(count));
  return 0;
}
