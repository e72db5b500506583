#!/usr/bin/env perl
# Smoke test of the Perl binding, covering the surface the reference's
# swig/test.pl exercises (de-novo build, contains, store/load round trip,
# getters, insertSeq + per-k-mer query). Exits non-zero on any failure —
# run by tests/test_perl_binding.py.

use strict;
use warnings;
use FindBin;
use lib "$FindBin::Bin/./";
use File::Temp qw(tempdir);
use BloomFilter;

my $fail = 0;
sub ok_that {
    my ($cond, $what) = @_;
    unless ($cond) { print "FAIL: $what\n"; $fail = 1; }
}

my $filter = BloomFilter::BloomFilter->new(1000000, 5, 20);
my @in = qw(ATCGGGTCATCAACCAATAT ATCGGGTCATCAACCAATAC
            ATCGGGTCATCAACCAATAG ATCGGGTCATCAACCAATAA);
$filter->insert($_) for @in;
ok_that($filter->contains($_), "contains $_") for @in;
ok_that(!$filter->contains("ATCGGGTCATCAACCAATTA"), "negative 1");
ok_that(!$filter->contains("ATCGGGTCATCAACCAATTC"), "negative 2");
print "de novo bf tests done\n";

my $dir = tempdir(CLEANUP => 1);
my $file = "$dir/BloomFilter.bf";
$filter->storeFilter($file);
my $filter2 = BloomFilter::BloomFilter->new($file);
ok_that($filter2->contains($_), "reloaded contains $_") for @in;
ok_that(!$filter2->contains("ATCGGGTCATCAACCAATTA"), "reloaded negative");
print "premade bf tests done\n";

my ($pop, $hash, $ksize, $size) = ($filter2->getPop, $filter2->getHashNum,
                                   $filter2->getKmerSize,
                                   $filter2->getFilterSize);
ok_that($pop > 0 && $pop <= 20, "pop sane ($pop)");
ok_that($hash == 5,       "hashNum ($hash)");
ok_that($ksize == 20,     "kmerSize ($ksize)");
ok_that($size == 1000000, "filterSize ($size)");
print "Filter Info: Pop - $pop, numHash - $hash, kmerSize - $ksize, "
    . "size - $size\n";

my $k = 5;
my $str = "TAGAATCACCCAAAGA";
my $bloom = BloomFilter::BloomFilter->new(10000, 4, $k);
BloomFilter::insertSeq($bloom, $str, 4, $k);
for my $i (0 .. length($str) - $k) {
    my $kmer = substr($str, $i, $k);
    ok_that($bloom->contains($kmer), "insertSeq kmer $kmer");
}
print $fail ? "FAILED\n" : "Done!\n";
exit $fail;
